"""The port's int8 partitioned rows (gigl_tpu_torch.training.dist_sampled
PartitionedGraph.build(quantize_features=True), decode_rows / split_rows,
the decoded routed gather of parallel/feature_lookup.py) against the JAX
reference on the CPU, where K3, K12's packed-row mode and K16's int8 mode
run their plain twins. The toy is the multi-chip dryrun's: 512 nodes,
4,096 edges, D 16 (and an odd D 13: 21- and 38-byte rows, the tail's
words off any 4-byte boundary), fanouts (5, 3), GraphSAGE hidden 32, out
16, batch 64, 64 random negatives, capacity factor 8, at 1 and 4 shards.

Tolerances: the int8 rows, the label column and the CSR blocks BIT-EQUAL
to the reference's; decode_rows / split_rows over every real row
BIT-EQUAL (one fp32 multiply a value, as the reference's); the decoded
routed gather BIT-EQUAL to split_rows of the raw routed gather, dropped
requests all zero; the live trainer over int8 rows: the first step's loss
within 1e-6 relative (measured: equal) and 3-step trajectories within
rtol 1e-5 (the same math, sums in another order, through Adam).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

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
from gigl_tpu_torch.ops.quantized import (
    _gather_packed_rows_q8_plain,
    decode_packed_rows,
    gather_packed_rows_q8,
    packed_row_bytes,
)
from gigl_tpu_torch.parallel import feature_lookup as fl
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


def _graphs(n=N, d=16, labels=False, seed=0):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, 8 * n), rng.integers(0, n, 8 * n)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[3] = 0.0                        # an all-zero row: scale 1e-12 / 127
    kw = {"node_labels": rng.integers(0, 5, n)} if labels else {}
    jdg = JaxDeviceGraph.from_hetero(
        JaxHeteroGraph.homogeneous(src=src, dst=dst, num_nodes=n,
                                   node_features=x, **kw),
        supervision_edges=np.stack([src, dst]))
    dg = DeviceGraph.from_hetero(
        HeteroGraph.homogeneous(src=src, dst=dst, num_nodes=n,
                                node_features=x, **kw),
        supervision_edges=np.stack([src, dst]), device="cpu")
    return jdg, dg


@pytest.mark.parametrize("n,num_shards", [(512, 4), (250, 4), (512, 1)])
@pytest.mark.parametrize("d", [16, 13])
@pytest.mark.parametrize("labels", [False, True],
                         ids=["unlabeled", "labeled"])
def test_quantized_build_bit_equal(n, num_shards, d, labels):
    """The bit-packed [D + 8] int8 rows (uneven N: empty trailing rows),
    the [rows, 1] int32 label column and the CSR blocks."""
    jdg, dg = _graphs(n, d, labels)
    want = JaxPartitionedGraph.build(jdg, jax_make_mesh(num_shards),
                                     quantize_features=True)
    got = PartitionedGraph.build(dg, Mesh(num_shards, "cpu"),
                                 quantize_features=True)
    assert got.quantized and want.quantized
    assert got.feat_deg[0].dtype == torch.int8
    assert got.feat_deg[0].shape == (-(-n // num_shards),
                                     packed_row_bytes(d))
    np.testing.assert_array_equal(torch.cat(got.feat_deg).numpy(),
                                  np.asarray(want.feat_deg))
    for name in ("msg_indptr", "msg_indices", "sup_indptr", "sup_indices"):
        np.testing.assert_array_equal(
            torch.stack(getattr(got, name)).numpy(),
            np.asarray(getattr(want, name)), err_msg=name)
    if labels:
        assert got.labels[0].dtype == torch.int32
        np.testing.assert_array_equal(torch.cat(got.labels).numpy(),
                                      np.asarray(want.labels))
    else:
        assert got.labels is None and want.labels is None


@pytest.mark.parametrize("d", [16, 13])
@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
def test_decode_and_split_rows_bit_equal(d, quantize):
    """decode_rows and split_rows over every real row, uncached and with
    the cache fused in (the reference's tabularized rows fed to both)."""
    jdg, dg = _graphs(d=d)
    jm = jax_make_mesh(4)
    want = JaxPartitionedGraph.build(jdg, jm, quantize_features=quantize)
    got = PartitionedGraph.build(dg, Mesh(4, "cpu"),
                                 quantize_features=quantize)
    rows = np.array(want.feat_deg)[:N]
    for g_, w_ in zip(got.decode_rows(torch.from_numpy(rows)),
                      want.decode_rows(jnp.asarray(rows))):
        assert g_.dtype == torch.float32
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    tab = want.with_tabularized(jm, fanouts=FANOUTS, capacity_factor=8.0)
    rows = np.array(tab.feat_deg)[:N]
    got_c = dataclasses.replace(got, cache_dim=d)
    split = got_c.split_rows(torch.from_numpy(rows))
    for g_, w_ in zip(split, tab.split_rows(jnp.asarray(rows))):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    assert split[2].shape == (N, d)


@pytest.mark.parametrize("num_shards,capacity", [(1, None), (2, None),
                                                 (4, None), (4, 8)])
@pytest.mark.parametrize("d,dc", [(13, 0), (13, 13), (16, 16)])
def test_decoded_routed_gather_matches_split_rows(num_shards, capacity, d,
                                                  dc):
    """routed_gather(decode=(D, Dc)) (K12's packed-row twin on one shard,
    K16's int8 twin after the all_to_all) against split_rows of the raw
    routed gather; dropped requests (capacity 8) decode to zeros."""
    rng = np.random.default_rng(d + dc)
    rows = 60
    table = rng.integers(-127, 128, (num_shards * rows, d + dc)).astype(
        np.int8)
    words = rng.random((num_shards * rows, 3 if dc else 2)).astype(
        np.float32)
    packed = torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [table, words.view(np.int8)], axis=1)))
    tables = list(packed.reshape(num_shards, rows, -1).unbind(0))
    ids = [torch.from_numpy(rng.integers(0, num_shards * rows, 50).astype(
        np.int32)) for _ in range(num_shards)]
    mesh = Mesh(num_shards, "cpu")
    got, ok = fl.routed_gather(mesh, tables, ids, capacity=capacity,
                               decode=(d, dc))
    raw, ok_raw = fl.routed_gather(mesh, tables, ids, capacity=capacity)
    for s in range(num_shards):
        assert torch.equal(ok[s], ok_raw[s])
        want = decode_packed_rows(raw[s], d, dc)
        for g_, w_ in zip(got[s], want):
            assert (g_ is None) == (w_ is None)
            if w_ is not None:
                assert torch.equal(g_, w_)
        if capacity is not None:
            assert not bool(ok[s].all())
            assert float(got[s][0][~ok[s]].abs().sum()) == 0.0
            assert float(got[s][1][~ok[s]].abs().sum()) == 0.0
    if num_shards == 1:     # the closed form: K12's packed-row mode
        f, deg, c = gather_packed_rows_q8(tables[0], ids[0], d, dc)
        assert torch.equal(f, got[0][0]) and torch.equal(deg, got[0][1])


def test_packed_gather_clamps_ids():
    """K12's packed-row twin clamps ids into [0, N - 1] as XLA's gather
    does, and keeps the ids' shape."""
    rng = np.random.default_rng(3)
    table = torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [rng.integers(-127, 128, (10, 5)).astype(np.int8),
         rng.random((10, 2)).astype(np.float32).view(np.int8)], axis=1)))
    ids = torch.tensor([[-4, 0], [9, 40]], dtype=torch.int32)
    f, deg, c = _gather_packed_rows_q8_plain(table, ids, 5)
    want = decode_packed_rows(table[[0, 0, 9, 9]], 5)
    assert f.shape == (2, 2, 5) and deg.shape == (2, 2) and c is None
    assert torch.equal(f.reshape(4, 5), want[0])
    assert torch.equal(deg.reshape(4), want[1])
    with pytest.raises(ValueError, match="bytes"):
        decode_packed_rows(table, 6)


def _pair(num_shards, d=16, **cfg):
    jdg, dg = _graphs(d=d)
    kw = dict(fanouts=FANOUTS, num_random_negs=R, eval_ks=(1, 10))
    kw.update(cfg)
    jm = jax_make_mesh(num_shards)
    jt = JaxPartitionedNALPTrainer(
        JaxLPGNN(encoder=JaxGNNEncoder(hid_dim=HID, out_dim=OUT,
                                       dropout=0.0), decoder=JaxDecoder()),
        JaxPartitionedGraph.build(jdg, jm, quantize_features=True), jm,
        JaxConfig(**kw), optimizer_args=OPT, capacity_factor=8.0,
        overflow_policy="silent")
    js = jt.init_state(jax.random.PRNGKey(0), batch_size=B)
    mesh = Mesh(num_shards, "cpu")
    pt = PartitionedNALPTrainer(
        LinkPredictionGNN(GNNEncoder(d, HID, OUT), LinkPredictionDecoder()),
        PartitionedGraph.build(dg, mesh, quantize_features=True), mesh,
        NALPTrainerConfig(**kw), optimizer_args=OPT, capacity_factor=8.0,
        overflow_policy="silent")
    ps = pt.init_state(params=params_from_flax(
        jax.tree_util.tree_map(np.asarray, js.params)))
    return jt, js, pt, ps


@pytest.mark.parametrize("num_shards", [1, 4])
@pytest.mark.parametrize("d", [16, 13])
def test_live_trainer_over_int8_rows_matches_jax(num_shards, d):
    """The live partitioned NALP trainer over int8 rows (the sketch on):
    the first loss and a 3-step trajectory, zero overflow, and evaluate."""
    jt, js, pt, ps = _pair(num_shards, d, use_cms_correction=True)
    akb = np.random.default_rng(1).integers(0, N, (3, B)).astype(np.int32)
    js, jl = jt.train_steps(js, akb, jax.random.PRNGKey(1))
    ps, pl = pt.train_steps(ps, akb)
    jl, pl = np.asarray(jl), pl.numpy()
    assert abs(pl[0] - jl[0]) <= 1e-6 * abs(jl[0])
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pt.overflow_total == 0 == jt.overflow_total
    np.testing.assert_array_equal(ps.cms.table.numpy(),
                                  np.asarray(js.cms.table))
    batches = [np.arange(64, dtype=np.int32)]
    want = jt.evaluate(js.params, batches, step=2)
    got = pt.evaluate(batches, step=2)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k


def test_build_refuses_an_int8_feature_table():
    """A DeviceGraph whose features are already an int8 table: the
    partitioned rows quantize on the host from fp32 features instead."""
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 64, 300), rng.integers(0, 64, 300)
    dg = DeviceGraph.from_hetero(
        HeteroGraph.homogeneous(src=src, dst=dst, num_nodes=64,
                                node_features=rng.normal(size=(64, 8)).astype(
                                    np.float32)),
        device="cpu", quantize_features=True)
    with pytest.raises(ValueError, match="quantize_features"):
        PartitionedGraph.build(dg, Mesh(2, "cpu"))
