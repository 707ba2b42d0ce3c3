"""The port's streamed-partitioned tier (gigl_tpu_torch.training.
streaming_partitioned: ShardedHostStore and the NALP, typed NALP and
node-classification trainers over host-resident rows with routed device
lookups) against the JAX reference and against the port's device-resident
partitioned trainers, on the CPU, where every kernel runs its plain twin
and the host round trip runs without pinning or streams.

The toy is the multi-chip dryrun's: 512 nodes, 4,096 edges, D 16, fanouts
(5, 3), GraphSAGE hidden 32, out 16, batch 64, 64 random negatives,
capacity factor 8, at 1 and 4 shards; the label-edge case gives the
supervision and hard-negative edges 3 features and the model an
EdgeFeatureScorer of hidden 8. The typed trainer runs the DBLP-shaped toy
of tests/test_torch_dist_hetero.py (batch 16, 24 random negatives) with its
features on the host; the NC trainer 4 classes (``arange(N) % 4``).

Tolerances: the fused host rows and every ``answer_shard`` (padding ids
included) BIT-EQUAL to the reference's ``ShardedHostStore``; the bf16
answers bit-equal to ``to_bfloat16`` of the fp32 rows; the plan's ``recv``
ids bit-equal and its overflow counts equal; ``refresh_cache``'s tables
bit-equal. Losses: the first step within 1e-5 relative of the reference's
streamed trainer and 3-step trajectories (sequential and pipelined) within
1e-5 (the same math, sums in another order, through Adam); against the
port's device-resident ``PartitionedNALPTrainer(cached_hop=True)`` within
2e-5, the reference's own rtol (tests/test_streaming_partitioned.py:96-97)
(measured: equal); the two schedules equal to the bit. bf16 answers: the
port's bf16 trainer against the reference's bf16 trainer within 1e-5 (each
casts the same fp32 rows to the same bits, so the difference is the fp32
one's), and against fp32 within the reference's 5e-2. evaluate's metrics
within 1e-6 absolute; encode_batch and NC logits within 1e-5 of their scale
of the reference's and of the device-resident trainers' (batches of another
size: the CPU's matrix products may round otherwise).
"""

import functools

import numpy as np
import pytest
import torch

import jax

from gigl_tpu.models.encoders import GNNEncoder as JaxGNNEncoder
from gigl_tpu.models.hetero_encoders import (
    HeteroGNNEncoder as RefHeteroEncoder,
)
from gigl_tpu.models.link_prediction import (
    EdgeFeatureScorer as JaxScorer,
    HeteroLinkPredictionGNN as RefHeteroLP,
    LinkPredictionDecoder as JaxDecoder,
    LinkPredictionGNN as JaxLPGNN,
)
from gigl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gigl_tpu.training.dist_hetero import (
    PartitionedHeteroGraph as RefPartitionedHeteroGraph,
)
from gigl_tpu.training.hetero_trainer import (
    HeteroNALPTrainerConfig as RefHeteroConfig,
)
from gigl_tpu.training.streaming import HostGraphStore as JaxHostGraphStore
from gigl_tpu.training.streaming_partitioned import (
    ShardedHostStore as JaxShardedHostStore,
    StreamingPartitionedHeteroNALPTrainer as JaxTypedStreamed,
    StreamingPartitionedNALPTrainer as JaxStreamed,
    StreamingPartitionedNodeClassificationTrainer as JaxNCStreamed,
)
from gigl_tpu.training.trainer import (
    NALPTrainerConfig as JaxConfig,
    NodeClassificationTrainerConfig as JaxNCConfig,
)
from gigl_tpu_torch.convert import params_from_flax
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.models.encoders import GNNEncoder
from gigl_tpu_torch.models.hetero_encoders import HeteroGNNEncoder
from gigl_tpu_torch.models.link_prediction import (
    EdgeFeatureScorer,
    HeteroLinkPredictionGNN,
    LinkPredictionDecoder,
    LinkPredictionGNN,
)
from gigl_tpu_torch.parallel.mesh import Mesh, make_mesh
from gigl_tpu_torch.training.dataset import DeviceGraph
from gigl_tpu_torch.training.dist_hetero import (
    PartitionedHeteroGraph,
    PartitionedHeteroNALPTrainer,
)
from gigl_tpu_torch.training.dist_sampled import (
    PartitionedGraph,
    PartitionedNALPTrainer,
    PartitionedNodeClassificationTrainer,
)
from gigl_tpu_torch.training.hetero_trainer import HeteroNALPTrainerConfig
from gigl_tpu_torch.training.streaming import HostGraphStore
from gigl_tpu_torch.training.streaming_partitioned import (
    ShardedHostStore,
    StreamingPartitionedHeteroNALPTrainer,
    StreamingPartitionedNALPTrainer,
    StreamingPartitionedNodeClassificationTrainer,
)
from gigl_tpu_torch.training.trainer import (
    NALPTrainerConfig,
    NodeClassificationTrainerConfig,
)
from gigl_tpu_torch.utils.cast import to_bfloat16
from tests.test_torch_dist_hetero import (
    B as TB,
    _anchors as _typed_anchors,
    _conv_kw,
    _graphs as _typed_graphs,
)
from tests.test_torch_hetero_training import (
    DBLP_CFG,
    DBLP_OPT,
    DIMS,
    EDGE_TYPES,
    NODE_TYPES,
)

torch.set_num_threads(1)

N, E, D, HID, OUT, B, R = 512, 4096, 16, 32, 16, 64, 64
FANOUTS, SEED, STEPS = (5, 3), 7, 3
OPT = {"learning_rate": "0.01"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _data(label_edges=False, labels=False):
    """(edges [2, E], features [N, D], extra HostGraphStore.build kwargs)."""
    rng = np.random.default_rng(11 if label_edges else 0)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    x = rng.normal(size=(N, D)).astype(np.float32)
    extra = {}
    if label_edges:
        extra = dict(
            hard_neg_edges=np.stack([dst, src]),
            supervision_edge_features=np.stack(
                [src, dst, src + dst], 1).astype(np.float32),
            hard_neg_edge_features=np.stack(
                [dst, src, dst - src], 1).astype(np.float32))
    if labels:
        extra["node_labels"] = np.arange(N) % 4
    return np.stack([src, dst]), x, extra


def _stores(label_edges=False, labels=False):
    """(reference store, port store) over the same inputs."""
    edges, x, extra = _data(label_edges, labels)
    kw = dict(message_edges=edges, supervision_edges=edges, features=x,
              num_nodes=N, fanouts=FANOUTS, seed=SEED, **extra)
    return JaxHostGraphStore.build(**kw), HostGraphStore.build(**kw)


def _device_graph(label_edges=False, labels=False) -> DeviceGraph:
    edges, x, extra = _data(label_edges, labels)
    g = HeteroGraph.homogeneous(src=edges[0], dst=edges[1], num_nodes=N,
                                node_features=x,
                                node_labels=extra.get("node_labels"))
    return DeviceGraph.from_hetero(
        g, supervision_edges=None if labels else edges,
        hard_neg_edges=extra.get("hard_neg_edges"),
        supervision_edge_features=extra.get("supervision_edge_features"),
        hard_neg_edge_features=extra.get("hard_neg_edge_features"),
        device="cpu")


def _models(label_edges):
    jax_model = JaxLPGNN(
        encoder=JaxGNNEncoder(hid_dim=HID, out_dim=OUT, num_layers=2,
                              conv="graphsage", dropout=0.0),
        decoder=JaxDecoder(),
        edge_scorer=JaxScorer(hidden_dim=8) if label_edges else None)

    def port_model():
        return LinkPredictionGNN(
            GNNEncoder(D, HID, OUT), LinkPredictionDecoder(),
            EdgeFeatureScorer(3, hidden_dim=8) if label_edges else None)
    return jax_model, port_model


def _cfg_kw(**cfg):
    return dict(dict(fanouts=FANOUTS, num_random_negs=R,
                     loss_type="retrieval", cached_hop=True, seed=SEED),
                **cfg)


def _pair(num_shards, label_edges=False, capacity_factor=8.0,
          answer_dtype="float32", overflow_policy="raise", **cfg):
    """(reference streamed trainer, its state, a factory of port streamed
    trainers (trainer, state) from the reference's initial weights, those
    weights as a state dict)."""
    jax_model, port_model = _models(label_edges)
    kw = _cfg_kw(**cfg)
    jstore, _ = _stores(label_edges)
    jt = JaxStreamed(jax_model, jstore, jax_make_mesh(num_shards),
                     JaxConfig(**kw), batch_size=B,
                     capacity_factor=capacity_factor,
                     overflow_policy=overflow_policy,
                     answer_dtype=answer_dtype, optimizer_args=OPT)
    js = jt.init_state(jax.random.PRNGKey(0))
    params = params_from_flax(_np(js.params))

    def port(dtype=answer_dtype):
        pt = StreamingPartitionedNALPTrainer(
            port_model(), _stores(label_edges)[1], Mesh(num_shards, "cpu"),
            NALPTrainerConfig(**kw), batch_size=B,
            capacity_factor=capacity_factor,
            overflow_policy=overflow_policy, answer_dtype=dtype,
            optimizer_args=OPT)
        return pt, pt.init_state(params=params)
    return jt, js, port, params


def _device_resident(num_shards, params, label_edges=False, **cfg):
    _, port_model = _models(label_edges)
    mesh = Mesh(num_shards, "cpu")
    pt = PartitionedNALPTrainer(
        port_model(), PartitionedGraph.build(_device_graph(label_edges),
                                             mesh),
        mesh, NALPTrainerConfig(**_cfg_kw(**cfg)), optimizer_args=OPT,
        capacity_factor=8.0, overflow_policy="raise")
    return pt, pt.init_state(params=params)


def _anchors(k, seed=3):
    return np.random.default_rng(seed).integers(0, N, (k, B)).astype(
        np.int32)


def _jax_losses(jt, js, akb):
    out = []
    for i, a in enumerate(akb):
        js, loss = jt.train_step(js, a, np.asarray(jax.random.PRNGKey(i)), i)
        out.append(float(loss))
    return js, np.asarray(out)


def _close_emb(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# -- the host store -----------------------------------------------------------
@pytest.mark.parametrize("num_shards", [1, 4])
def test_sharded_host_store_bit_equal(num_shards):
    """The fused [feat | deg | agg] rows and the owner-side answers, the
    padding ids clipped into the shard's range, bit-equal to the
    reference's; the bf16 answers are the fp32 rows' bf16 bits."""
    jstore, store = _stores()
    want = JaxShardedHostStore.from_host_store(jstore,
                                               num_shards=num_shards)
    got = ShardedHostStore.from_host_store(store, num_shards=num_shards)
    rows = -(-N // num_shards)
    assert got.table.shape == (num_shards * rows, 2 * D + 1) == \
        want._np.shape and got.width == want.width
    np.testing.assert_array_equal(got.table, want._np)
    rng = np.random.default_rng(5)
    for s in range(num_shards):
        # the shard's own ids, and padding slots' id 0 (outside shard s > 0)
        ids = np.concatenate([rng.integers(s * rows, (s + 1) * rows, 37),
                              np.zeros(11, np.int64)]).reshape(
                                  num_shards if num_shards == 4 else 1, -1)
        np.testing.assert_array_equal(got.answer_shard(s, ids),
                                      want.answer_shard(s, ids))
        out = np.empty(ids.shape + (got.width,), np.uint16)
        got.answer_into(s, ids, out, bf16=True)
        np.testing.assert_array_equal(out, to_bfloat16(
            want.answer_shard(s, ids)))
    if num_shards == 4:
        sub = ShardedHostStore.from_host_store(store, num_shards=4,
                                               local_shards=[2])
        ref = JaxShardedHostStore.from_host_store(jstore, num_shards=4,
                                                  local_shards=[2])
        np.testing.assert_array_equal(sub.table, ref._np)
        ids = np.arange(2 * rows, 3 * rows)
        np.testing.assert_array_equal(sub.answer_shard(2, ids),
                                      ref.answer_shard(2, ids))
    typed = rng.normal(size=(83, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        ShardedHostStore.from_array(typed, num_shards=num_shards).table,
        JaxShardedHostStore.from_array(typed, num_shards=num_shards)._np)


# -- the NALP trainer ---------------------------------------------------------
@pytest.mark.parametrize("num_shards", [1, 4])
def test_plan_and_trajectories_match(num_shards):
    """The plan's recv ids (a [1, C] routed array at one shard) bit-equal
    and its overflow counts equal; the first loss and 3-step trajectories,
    sequential and pipelined, against the reference's streamed trainer and
    the port's device-resident cached trainer; evaluate and encode_batch
    from the same weights against the device-resident trainer and, at 4
    shards, the reference."""
    jt, js, port, params = _pair(num_shards)
    akb = _anchors(STEPS)
    seq, ss = port()
    plan = seq._plan(akb[1], 5)
    jplan = jt._plan_step(akb[1], 5)
    cap = seq._capacity(seq._union_sizes(False)[0])
    assert plan.recvs[0].shape == (num_shards, num_shards, cap)
    np.testing.assert_array_equal(
        plan.recvs[0].reshape(-1, cap).numpy(), np.asarray(jplan[0]))
    assert int(plan.ctx[3]) == int(np.asarray(jplan[-1])) == 0
    # evaluate and encode from the initial weights (against the reference
    # at 4 shards: its eval and encode programs compile slowly)
    dev, ds = _device_resident(num_shards, params)
    batches = [akb[0], akb[2]]
    got_m = seq.evaluate(batches, step=4)
    assert got_m == dev.evaluate(batches, step=4)
    ids = (np.arange(70, dtype=np.int32) * 7) % N      # two wrapped chunks
    got_e = seq.encode_batch(ids)
    _close_emb(got_e, dev.encode_batch(ids).numpy())
    if num_shards == 4:
        want_m = jt.evaluate(js.params, batches, step=4)
        assert set(got_m) == set(want_m)
        for k in want_m:
            assert abs(got_m[k] - want_m[k]) <= 1e-6, k
        _close_emb(got_e, jt.encode_batch(js.params, ids))
    assert seq.encode_batch(np.zeros(0, np.int32)).shape == (0, OUT)
    # the trajectories
    js, want = _jax_losses(jt, js, akb)
    got_seq = []
    for a in akb:
        ss, loss = seq.train_step(ss, a)
        got_seq.append(float(loss))
    got_seq = np.asarray(got_seq)
    pipe, ps = port()
    ps, got_pipe = pipe.run_steps(ps, list(akb))
    np.testing.assert_array_equal(got_seq, got_pipe)
    assert abs(got_seq[0] - want[0]) <= 1e-5 * abs(want[0])
    np.testing.assert_allclose(got_seq, want, rtol=1e-5)
    ds, got_dev = dev.train_steps(ds, akb)
    np.testing.assert_allclose(got_seq, got_dev.numpy(), rtol=2e-5)
    assert ss.step == ps.step == STEPS
    assert seq.overflow_total == pipe.overflow_total == jt.overflow_total == 0
    for a, b in zip(seq.model.parameters(), pipe.model.parameters()):
        assert torch.equal(a, b)


def test_ring_sketch_and_label_edges_match_jax():
    """The dryrun's first check (the ring pool with the sketch on) with
    label-edge features, a hard negative and the edge scorer (K17's
    own-block bias mode) at 4 shards: trajectories against the reference
    and the device-resident trainer, the sketch table equal."""
    cfg = dict(global_candidate_pool=True, use_cms_correction=True,
               num_hard_negs=1)
    jt, js, port, params = _pair(4, label_edges=True, **cfg)
    akb = _anchors(STEPS, seed=12)
    js, want = _jax_losses(jt, js, akb)
    pt, ps = port()
    ps, got = pt.run_steps(ps, list(akb))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(ps.cms.table.numpy(),
                                  np.asarray(js.cms.table))
    dev, ds = _device_resident(4, params, label_edges=True, **cfg)
    ds, got_dev = dev.train_steps(ds, akb)
    np.testing.assert_allclose(got, got_dev.numpy(), rtol=2e-5)
    assert torch.equal(ps.cms.table, ds.cms.table)


def test_bf16_answers_match_the_references_cast():
    """answer_dtype="bfloat16": the port's bf16 trainer against the
    reference's bf16 trainer (the same bits reach both encoders) within
    1e-5, and against the port's fp32 trainer within the reference's 5e-2;
    the answer slot is int16 (bf16 bits) and half the fp32 bytes."""
    jt, js, port, _ = _pair(4, answer_dtype="bfloat16")
    akb = _anchors(2, seed=6)
    js, want = _jax_losses(jt, js, akb)
    p16, s16 = port()
    s16, got16 = p16.run_steps(s16, list(akb))
    np.testing.assert_allclose(got16, want, rtol=1e-5)
    p32, s32 = port("float32")
    s32, got32 = p32.run_steps(s32, list(akb))
    np.testing.assert_allclose(got16, got32, rtol=5e-2)
    assert not np.array_equal(got16, got32)
    slot16 = next(iter(p16._rings.values()))[0]
    slot32 = next(iter(p32._rings.values()))[0]
    assert slot16.ans[0].dtype == torch.int16
    assert 2 * slot16.nbytes == slot32.nbytes


def test_overflow_counts_and_grow_match_jax():
    """A capacity factor of 0.3 drops routed requests: the counts equal
    the reference's, the losses agree, and the grow policy doubles the
    factor and resizes the answer slots as the reference's does."""
    jt, js, port, _ = _pair(4, capacity_factor=0.3, overflow_policy="grow")
    akb = _anchors(2, seed=4)
    js, want = _jax_losses(jt, js, akb[:1])
    pt, ps = port()
    ps, got = pt.train_step(ps, akb[0])
    assert pt.overflow_total == jt.overflow_total > 0
    assert pt.capacity_factor == jt.capacity_factor == 0.6
    np.testing.assert_allclose(float(got), want[0], rtol=1e-5)
    cap = pt._capacity(pt._union_sizes(False)[0])
    plan = pt._plan(akb[1], 1)
    assert plan.recvs[0].shape[-1] == cap == jt.capacity
    np.testing.assert_array_equal(plan.recvs[0].reshape(-1, cap).numpy(),
                                  np.asarray(jt._plan_step(akb[1], 1)[0]))


def test_refresh_cache_tables_bit_equal():
    """refresh_cache(epoch) redraws the store's tables with seed + 1_299_709
    * epoch: the device tables and the fused host rows bit-equal to the
    reference's refresh, not epoch 0's; a supplied host_store refuses."""
    jstore, store = _stores()
    jax_model, port_model = _models(False)
    kw = _cfg_kw()
    jt = JaxStreamed(jax_model, jstore, jax_make_mesh(4), JaxConfig(**kw),
                     batch_size=B, capacity_factor=8.0)
    pt = StreamingPartitionedNALPTrainer(
        port_model(), store, Mesh(4, "cpu"), NALPTrainerConfig(**kw),
        batch_size=B, capacity_factor=8.0)
    t0 = torch.cat(pt.pg.sample_tables[0]).numpy()
    np.testing.assert_array_equal(t0, np.asarray(jt._tabs[0]))
    jt.refresh_cache(epoch=1)
    pt.refresh_cache(epoch=1)
    t1 = torch.cat(pt.pg.sample_tables[0]).numpy()
    assert (t0 != t1).any()
    np.testing.assert_array_equal(t1, np.asarray(jt._tabs[0]))
    np.testing.assert_array_equal(pt.host.table, jt.host._np)
    fixed = StreamingPartitionedNALPTrainer(
        port_model(), store, Mesh(4, "cpu"), NALPTrainerConfig(**kw),
        batch_size=B, host_store=ShardedHostStore.from_host_store(
            store, num_shards=4))
    with pytest.raises(ValueError, match="host_store"):
        fixed.refresh_cache(epoch=2)


def test_refusals():
    _, store = _stores()
    _, port_model = _models(False)
    mesh = Mesh(4, "cpu")

    def make(cfg=None, **kw):
        return StreamingPartitionedNALPTrainer(
            port_model(), store, mesh,
            cfg or NALPTrainerConfig(**_cfg_kw()), **{"batch_size": B, **kw})

    with pytest.raises(ValueError, match="cached_hop"):
        make(NALPTrainerConfig(fanouts=FANOUTS, num_random_negs=R))
    with pytest.raises(ValueError, match="retrieval-loss"):
        make(NALPTrainerConfig(**_cfg_kw(loss_type="margin",
                                         global_candidate_pool=True)))
    with pytest.raises(ValueError, match="divisible"):
        make(batch_size=30)
    with pytest.raises(ValueError, match="num_random_negs"):
        make(NALPTrainerConfig(**_cfg_kw(num_random_negs=66)))
    with pytest.raises(ValueError, match="hard_neg"):
        make(NALPTrainerConfig(**_cfg_kw(num_hard_negs=2)))
    with pytest.raises(ValueError, match="overflow_policy"):
        make(overflow_policy="drop")
    with pytest.raises(ValueError, match="answer_dtype"):
        make(answer_dtype="float16")
    with pytest.raises(ValueError, match="fanouts"):
        make(NALPTrainerConfig(**_cfg_kw(fanouts=(4, 3))))
    with pytest.raises(ValueError, match="batch"):
        make().train_step(make().init_state(0), np.arange(B // 2))
    with pytest.raises(ValueError, match="node_labels"):
        StreamingPartitionedNodeClassificationTrainer(
            GNNEncoder(D, HID, 4), store, mesh,
            NodeClassificationTrainerConfig(fanouts=FANOUTS,
                                            cached_hop=True), batch_size=B)


def test_entry_points_need_cuda_by_default(monkeypatch):
    """With device=None and no CUDA the mesh (the trainers' device) raises:
    the tier never drops to the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        Mesh(1)


def test_fit_runs_the_nalp_loop():
    """fit through the shared loop: full train and val batches, the val
    cadence, the best weights loaded back; the same final metrics as the
    reference's fit."""
    jt, js, port, _ = _pair(4)
    pt, ps = port()
    kw = dict(num_epochs=1, val_every_n_batches=4, num_val_batches=1,
              early_stop_patience=2, log_every=0)
    train, val = np.arange(N), np.arange(40)
    _, want = jt.fit(js, train, val, **kw)
    ps, got = pt.fit(ps, train, val, **kw)
    assert ps.step == N // B and set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-3, k
    with pytest.raises(ValueError, match="batch_size"):
        pt.fit(ps, train, val, batch_size=32)


# -- the typed trainer --------------------------------------------------------
# (config, against the reference's streamed typed trainer too): every
# config against the port's device-resident typed trainer, which
# tests/test_torch_dist_hetero.py holds to the reference in each of them
TYPED = {"hgt_live": (dict(), False),
         "hgt_tabularized_one_shard": (dict(tabularized=True, num_shards=1),
                                       False),
         "rgcn_ring_tabularized": (dict(conv="rgcn", tabularized=True,
                                        global_candidate_pool=True), True)}


def _typed(conv="hgt", num_shards=4, tabularized=False, with_jax=False,
           **cfg):
    """(reference streamed typed trainer and its state, or Nones; port
    streamed typed trainer, its state; port device-resident trainer, its
    state), from one set of weights (the reference's, with ``with_jax``)."""
    rdg, dg, ref_paths, paths = _typed_graphs("plain")
    kw = {**DBLP_CFG, "tabularized": tabularized, **cfg}
    mesh = Mesh(num_shards, "cpu")
    hpg = PartitionedHeteroGraph.build(dg, paths, mesh,
                                       anchor_node_type="paper",
                                       features_on_device=False)
    dpg = PartitionedHeteroGraph.build(dg, paths, mesh,
                                       anchor_node_type="paper")
    if tabularized:
        hpg = hpg.with_sample_tables(dg, paths, mesh, seed=kw["seed"])
        dpg = dpg.with_sample_tables(dg, paths, mesh, seed=kw["seed"])

    def model():
        return HeteroLinkPredictionGNN(
            HeteroGNNEncoder(16, 8, NODE_TYPES, EDGE_TYPES, DIMS, conv=conv,
                             **_conv_kw(conv)), LinkPredictionDecoder())

    pt = StreamingPartitionedHeteroNALPTrainer(
        model(), hpg, paths, HeteroNALPTrainerConfig(**kw), mesh,
        batch_size=TB, host_features={nt: f.numpy() for nt, f
                                      in dg.node_features.items()},
        capacity_factor=8.0, overflow_policy="raise",
        optimizer_args=DBLP_OPT)
    dt = PartitionedHeteroNALPTrainer(
        model(), dpg, paths, HeteroNALPTrainerConfig(**kw), mesh,
        optimizer_args=DBLP_OPT, capacity_factor=8.0,
        overflow_policy="raise")
    jt = js = None
    if with_jax:
        jm = jax_make_mesh(num_shards)
        rpg = RefPartitionedHeteroGraph.build(rdg, ref_paths, jm,
                                              anchor_node_type="paper",
                                              features_on_device=False)
        if tabularized:
            rpg = rpg.with_sample_tables(rdg, ref_paths, jm,
                                         seed=kw["seed"])
        jt = JaxTypedStreamed(
            RefHeteroLP(encoder=RefHeteroEncoder(
                hid_dim=16, out_dim=8, num_layers=2, conv=conv,
                node_types=NODE_TYPES, edge_types=EDGE_TYPES,
                **_conv_kw(conv)), decoder=JaxDecoder()),
            rpg, ref_paths, RefHeteroConfig(**kw), jm, batch_size=TB,
            host_features={nt: np.asarray(f)
                           for nt, f in rdg.node_features.items()},
            capacity_factor=8.0, overflow_policy="raise",
            optimizer_args=DBLP_OPT)
        js = jt.init_state(jax.random.PRNGKey(1), batch_size=TB)
        params = params_from_flax(_np(js.params))
    else:
        dt.init_state(1)
        params = {k: v.clone() for k, v in dt.model.state_dict().items()}
    return (jt, js, pt, pt.init_state(params=params), dt,
            dt.init_state(params=params))


@pytest.mark.parametrize("name", list(TYPED))
def test_typed_trainer_matches(name):
    """3 steps, sequential and pipelined (equal to the bit), against the
    port's device-resident typed trainer (2e-5) and, for the ring config
    (the dryrun's second check), the reference's streamed typed trainer
    (1e-5); evaluate and the anchor type's encode_batch against the
    device-resident trainer's; no feature table on the device."""
    cfg, with_jax = TYPED[name]
    jt, js, pt, ps, dt, ds = _typed(with_jax=with_jax, **cfg)
    assert pt.pg.feats is None and dt.pg.feats is not None
    val = [_typed_anchors(1, seed=9)[0]]
    want_m = dt.evaluate(val, step=5)
    got_m = pt.evaluate(val, step=5)
    for k in want_m:
        assert abs(got_m[k] - want_m[k]) <= 1e-6, k
    ids = np.arange(0, 80, 3, dtype=np.int32)             # 27: two chunks
    _close_emb(pt.encode_batch(ids), dt.encode_batch(ids).numpy())
    with pytest.raises(ValueError, match="anchor node type"):
        pt.encode_batch(ids, node_type="author")
    akb = _typed_anchors(STEPS)
    first = {k: v.clone() for k, v in dt.model.state_dict().items()}
    seq_losses = []
    for a in akb:
        ps, loss = pt.train_step(ps, a)
        seq_losses.append(float(loss))
    ps2, got = pt.run_steps(pt.init_state(params=first), list(akb))
    np.testing.assert_array_equal(np.asarray(seq_losses), got)
    ds, got_dev = dt.train_steps(ds, akb)
    np.testing.assert_allclose(got, got_dev.numpy(), rtol=2e-5)
    assert pt.overflow_total == 0
    if with_jax:
        js, want = jt.run_steps(js, akb, jax.random.PRNGKey(1))
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)
        assert jt.overflow_total == 0


def test_typed_refusals():
    _, dg, _, paths = _typed_graphs("plain")
    mesh = Mesh(4, "cpu")
    hpg = PartitionedHeteroGraph.build(dg, paths, mesh,
                                       anchor_node_type="paper",
                                       features_on_device=False)
    cfg = HeteroNALPTrainerConfig(**DBLP_CFG)

    def model():
        return HeteroLinkPredictionGNN(HeteroGNNEncoder(
            16, 8, NODE_TYPES, EDGE_TYPES, DIMS, heads=2),
            LinkPredictionDecoder())

    with pytest.raises(ValueError, match="host_features"):
        StreamingPartitionedHeteroNALPTrainer(model(), hpg, paths, cfg, mesh,
                                              batch_size=TB)
    feats = {nt: f.numpy() for nt, f in dg.node_features.items()}
    with pytest.raises(ValueError, match="no host store"):
        StreamingPartitionedHeteroNALPTrainer(
            model(), hpg, paths, cfg, mesh, batch_size=TB,
            host_features={"paper": feats["paper"]})
    with pytest.raises(ValueError, match="divisible"):
        StreamingPartitionedHeteroNALPTrainer(
            model(), hpg, paths, cfg, mesh, batch_size=TB + 2,
            host_features=feats)
    # the device-resident trainer refuses a graph without device features
    dt = PartitionedHeteroNALPTrainer(model(), hpg, paths, cfg, mesh)
    with pytest.raises(ValueError, match="features_on_device=False"):
        dt.train_step(dt.init_state(0), _typed_anchors(1)[0])


# -- the node-classification trainer ------------------------------------------
def test_node_classification_matches():
    """The dryrun's third check at 4 shards: 3 pipelined steps (labels by a
    routed gather inside the plan) against the reference's streamed NC
    trainer (1e-5) and the port's device-resident NC trainer (2e-5); the
    accuracy and the logits of predict_batch; fit learns."""
    jstore, store = _stores(labels=True)
    jm, mesh = jax_make_mesh(4), Mesh(4, "cpu")
    jt = JaxNCStreamed(
        JaxGNNEncoder(hid_dim=HID, out_dim=4, num_layers=2,
                      conv="graphsage", dropout=0.0), jstore, jm,
        JaxNCConfig(fanouts=FANOUTS, cached_hop=True, seed=SEED),
        batch_size=B, capacity_factor=8.0, overflow_policy="raise",
        optimizer_args=OPT)
    js = jt.init_state(jax.random.PRNGKey(0))
    params = params_from_flax(_np(js.params))
    cfg = NodeClassificationTrainerConfig(fanouts=FANOUTS, cached_hop=True,
                                          seed=SEED)
    pt = StreamingPartitionedNodeClassificationTrainer(
        GNNEncoder(D, HID, 4), store, mesh, cfg, batch_size=B,
        capacity_factor=8.0, overflow_policy="raise", optimizer_args=OPT)
    ps = pt.init_state(params=params)
    dt = PartitionedNodeClassificationTrainer(
        GNNEncoder(D, HID, 4), PartitionedGraph.build(
            _device_graph(labels=True), mesh), mesh, cfg,
        optimizer_args=OPT, capacity_factor=8.0, overflow_policy="raise")
    ds = dt.init_state(params=params)
    ids = np.arange(20)
    _close_emb(pt.predict_batch(ids), jt.predict_batch(js.params, ids))
    _close_emb(pt.predict_batch(ids), dt.predict_batch(ids).numpy())
    akb = ((np.arange(STEPS * B).reshape(STEPS, B) * 11) % N).astype(
        np.int32)
    js, want = jt.run_steps(js, list(akb), jax.random.PRNGKey(1))
    ps, got = pt.run_steps(ps, list(akb))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)
    ds, got_dev = dt.train_steps(ds, akb)
    np.testing.assert_allclose(got, got_dev.numpy(), rtol=2e-5)
    val = np.arange(2 * B, dtype=np.int32)
    acc = pt.evaluate([val[:B], val[B:]])
    assert acc == dt.evaluate([val[:B], val[B:]])
    assert abs(acc - jt.evaluate(js.params, [val[:B], val[B:]])) <= 1e-6
    _, metrics = pt.fit(ps, np.arange(N), np.arange(B), num_epochs=4,
                        log_every=0)
    assert metrics["accuracy"] > 0.4, metrics
