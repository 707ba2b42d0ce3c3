"""The port's partitioned NALP trainer (gigl_tpu_torch.training.
dist_sampled) against the JAX reference's PartitionedNALPTrainer on the
virtual CPU mesh, on the CPU, where every kernel runs its plain twin. The
toy is the multi-chip dryrun's: 512 nodes, 4,096 edges, D 16, fanouts
(5, 3), GraphSAGE hidden 32, out 16, batch 64, 64 random negatives, 4
shards, capacity factor 8.

Tolerances: the shards (features with the fused degree column, the CSR
blocks with their padding) and the count-min sketch after training are
BIT-EQUAL; the first step's loss within 1e-6 relative (measured: equal);
10-step fp32 trajectories within rtol 1e-5 (measured up to 7.2e-6: the
same math, sums in another order, drifting through Adam); the ring loss at
1 and 4 shards and the replicated trainer's full-batch loss within 1e-5
relative (one logsumexp against a ring of them); the per-shard pool
against the mean of the replicated trainer's per-shard losses within 1e-5
relative; evaluate's metrics within 1e-6 and encode_batch within 1e-5 of
the embeddings' scale; run_partitioned_inference's exported rows from the
same (untrained) params within 1e-5 of the scale (measured 1.9e-7), the
exported ids equal, the rows equal to the port's encode_batch's.
"""

import logging

import numpy as np
import pytest
import torch

import jax

from gigl_tpu.graph.csr import HeteroGraph as JaxHeteroGraph
from gigl_tpu.inference.inferencer import (
    InferenceConfig as JaxInferenceConfig,
    run_partitioned_inference as jax_run_partitioned_inference,
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
    _shard_csr as jax_shard_csr,
)
from gigl_tpu.training.trainer import NALPTrainerConfig as JaxConfig
from gigl_tpu_torch.convert import params_from_flax
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.inference.inferencer import (
    InferenceConfig,
    run_partitioned_inference,
)
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
    _shard_csr,
)
from gigl_tpu_torch.training.trainer import NALPTrainer, NALPTrainerConfig

torch.set_num_threads(1)

N, E, D, HID, OUT, B, R = 512, 4096, 16, 32, 16, 64, 64
FANOUTS = (5, 3)
OPT = {"learning_rate": "0.01"}
STEPS = 10


def _arrays(n=N, e=E, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    keep = ~np.isin(dst, (5, 77))        # two anchors without positives
    hard = np.stack([rng.integers(0, n, 900), rng.integers(0, n, 900)])
    return (src[keep], dst[keep],
            rng.normal(size=(n, D)).astype(np.float32), hard)


def _graphs(n=N, e=E, hard=False):
    src, dst, x, hard_edges = _arrays(n, e)
    extra = {"hard_neg_edges": hard_edges} if hard else {}
    jdg = JaxDeviceGraph.from_hetero(
        JaxHeteroGraph.homogeneous(src=src, dst=dst, num_nodes=n,
                                   node_features=x),
        supervision_edges=np.stack([src, dst]), **extra)
    dg = DeviceGraph.from_hetero(
        HeteroGraph.homogeneous(src=src, dst=dst, num_nodes=n,
                                node_features=x),
        supervision_edges=np.stack([src, dst]), device="cpu", **extra)
    return jdg, dg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(num_shards=4, n=N, e=E, hard=False, capacity_factor=8.0, **cfg):
    """A JAX and a port partitioned trainer on the same graph and params:
    (jax trainer, jax state, port trainer, port state, port graph)."""
    kw = dict(fanouts=FANOUTS, num_random_negs=R, eval_ks=(1, 10))
    kw.update(cfg)
    jdg, dg = _graphs(n, e, hard)
    jm = jax_make_mesh(num_shards)
    jt = JaxPartitionedNALPTrainer(
        JaxLPGNN(encoder=JaxGNNEncoder(hid_dim=HID, out_dim=OUT,
                                       dropout=0.0), decoder=JaxDecoder()),
        JaxPartitionedGraph.build(jdg, jm), jm, JaxConfig(**kw),
        optimizer_args=OPT, capacity_factor=capacity_factor,
        overflow_policy="silent")
    js = jt.init_state(jax.random.PRNGKey(0), batch_size=B)
    mesh = Mesh(num_shards, "cpu")
    pt = PartitionedNALPTrainer(
        LinkPredictionGNN(GNNEncoder(D, HID, OUT), LinkPredictionDecoder()),
        PartitionedGraph.build(dg, mesh), mesh, NALPTrainerConfig(**kw),
        optimizer_args=OPT, capacity_factor=capacity_factor,
        overflow_policy="silent")
    ps = pt.init_state(params=params_from_flax(_np(js.params)))
    return jt, js, pt, ps, dg


def _anchors(k, seed=1, n=N):
    return np.random.default_rng(seed).integers(0, n, (k, B)).astype(
        np.int32)


CONFIGS = {
    "per_shard_cms": dict(use_cms_correction=True),
    "ring_cms": dict(use_cms_correction=True, global_candidate_pool=True),
    "ring_hard": dict(global_candidate_pool=True, num_hard_negs=1,
                      hard=True),
}


@pytest.fixture(scope="module")
def runs():
    """Per config: 10 steps of both trainers from the same params."""
    out = {}
    akb = _anchors(STEPS)
    for name, cfg in CONFIGS.items():
        jt, js, pt, ps, _ = _pair(**cfg)
        js, jl = jt.train_steps(js, akb, jax.random.PRNGKey(1))
        ps, pl = pt.train_steps(ps, akb)
        out[name] = dict(jax=np.asarray(jl), port=pl.numpy(), js=js, ps=ps,
                         jt=jt, pt=pt)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_first_step_loss_matches_jax(runs, name):
    r = runs[name]
    assert abs(r["port"][0] - r["jax"][0]) <= 1e-6 * abs(r["jax"][0])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trajectory_matches_jax(runs, name):
    r = runs[name]
    assert r["ps"].step == STEPS and r["port"].shape == (STEPS,)
    np.testing.assert_allclose(r["port"], r["jax"], rtol=1e-5)
    assert np.isfinite(r["jax"]).all()
    assert r["jax"][-3:].mean() < r["jax"][:3].mean()
    assert r["pt"].overflow_total == 0 == r["jt"].overflow_total


@pytest.mark.parametrize("name", ["per_shard_cms", "ring_cms"])
def test_sketch_bit_equal_after_training(runs, name):
    r = runs[name]
    np.testing.assert_array_equal(r["ps"].cms.table.numpy(),
                                  np.asarray(r["js"].cms.table))
    # every step counts the global pool once: B positives + R negatives
    assert int(r["ps"].cms.total) == int(r["js"].cms.total) == \
        STEPS * (B + R)


@pytest.mark.parametrize("n,num_shards", [(512, 4), (250, 4), (250, 8),
                                          (100, 1)])
def test_shard_csr_bit_equal(n, num_shards):
    src, dst, _, _ = _arrays(n, 6 * n)
    order = np.argsort(dst, kind="stable")
    indptr = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=n))])
    rows = -(-n // num_shards)
    want = jax_shard_csr(indptr, src[order], num_shards, rows)
    got = _shard_csr(indptr, src[order], num_shards, rows)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [512, 250], ids=["even", "uneven"])
def test_partitioned_graph_build_bit_equal(n):
    jdg, dg = _graphs(n, 8 * n, hard=True)
    want = JaxPartitionedGraph.build(jdg, jax_make_mesh(4))
    got = PartitionedGraph.build(dg, Mesh(4, "cpu"))
    assert got.rows_per_shard == want.rows_per_shard == -(-n // 4)
    assert (got.num_nodes, got.feat_dim, got.num_shards) == (n, D, 4)
    np.testing.assert_array_equal(torch.cat(got.feat_deg).numpy(),
                                  np.asarray(want.feat_deg))
    for name in ("msg_indptr", "msg_indices", "sup_indptr", "sup_indices",
                 "hard_indptr", "hard_indices"):
        np.testing.assert_array_equal(
            torch.stack(getattr(got, name)).numpy(),
            np.asarray(getattr(want, name)), err_msg=name)
    rows = torch.cat(got.feat_deg)[:7]
    f, deg = got.decode_rows(rows)
    assert torch.equal(f, rows[:, :D]) and torch.equal(deg, rows[:, D])


def test_uneven_nodes_margin_loss_matches_jax():
    """N = 250 over 4 shards (empty trailing rows) with the margin loss."""
    jt, js, pt, ps, _ = _pair(n=250, e=1500, loss_type="margin")
    akb = (np.arange(B, dtype=np.int32)[None, :] * 7) % 250
    _, jl = jt.train_steps(js, akb, jax.random.PRNGKey(1))
    _, pl = pt.train_steps(ps, akb)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-6)


def _trainer(num_shards, dg=None, **cfg):
    dg = dg if dg is not None else _graphs()[1]
    mesh = Mesh(num_shards, "cpu")
    kw = dict(fanouts=FANOUTS, num_random_negs=R, eval_ks=(1, 10))
    kw.update(cfg)
    torch.manual_seed(0)
    pt = PartitionedNALPTrainer(
        LinkPredictionGNN(GNNEncoder(D, HID, OUT), LinkPredictionDecoder()),
        PartitionedGraph.build(dg, mesh), mesh, NALPTrainerConfig(**kw),
        optimizer_args=OPT, capacity_factor=8.0)
    return pt, pt.init_state(seed=0)


def _first_loss(pt, state, anchors):
    _, losses = pt.train_steps(state, anchors[None, :])
    return float(losses[0])


def test_per_shard_pool_is_mean_of_replicated_losses():
    """A 4-shard step with the per-shard pool == the mean of the
    replicated trainer's losses on each shard's anchors with the shared
    random negatives (the reference's loss parity)."""
    dg = _graphs()[1]
    anchors = (np.arange(B, dtype=np.int32) * 3) % N
    pt, state = _trainer(4, dg)
    params = {k: v.clone() for k, v in pt.model.state_dict().items()}
    got = _first_loss(pt, state, anchors)
    ref = NALPTrainer(
        LinkPredictionGNN(GNNEncoder(D, HID, OUT), LinkPredictionDecoder()),
        dg, NALPTrainerConfig(fanouts=FANOUTS, num_random_negs=R),
        device="cpu")
    ref.init_state(params=params)
    with torch.no_grad():
        per_shard = [float(ref.loss(ref.sample_batch(a, 0)))
                     for a in anchors.reshape(4, -1)]
    assert abs(got - np.mean(per_shard)) <= 1e-5 * abs(got)


def test_ring_loss_is_the_full_batch_loss_at_any_shard_count():
    """The ring's global pool: 1 and 4 shards give the same loss, the
    replicated trainer's over the whole batch."""
    dg = _graphs()[1]
    anchors = (np.arange(B, dtype=np.int32) * 5) % N
    losses = []
    for p in (1, 4):
        pt, state = _trainer(p, dg, global_candidate_pool=True)
        losses.append(_first_loss(pt, state, anchors))
    ref = NALPTrainer(
        LinkPredictionGNN(GNNEncoder(D, HID, OUT), LinkPredictionDecoder()),
        dg, NALPTrainerConfig(fanouts=FANOUTS, num_random_negs=R),
        device="cpu")
    torch.manual_seed(0)
    ref.init_state(seed=0)
    with torch.no_grad():
        full = float(ref.loss(ref.sample_batch(anchors, 0)))
    for got in losses:
        assert abs(got - full) <= 1e-5 * abs(full)


def test_evaluate_matches_jax(runs):
    r = runs["per_shard_cms"]
    jt, pt = r["jt"], r["pt"]
    batches = [np.arange(64, dtype=np.int32),
               np.arange(100, 170, dtype=np.int32)]     # 70: cut to 68
    want = jt.evaluate(r["js"].params, batches, step=3)
    got = pt.evaluate(batches, step=3)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k


@pytest.mark.parametrize("m", [50, 64])
def test_encode_batch_matches_jax(runs, m):
    r = runs["ring_cms"]
    ids = (np.arange(m, dtype=np.int32) * 11) % N
    want = np.asarray(r["jt"].encode_batch(r["js"].params, ids))
    got = r["pt"].encode_batch(ids)
    assert got.shape == (m, OUT)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_overflow_count_matches_jax():
    """A capacity factor far too small: both trainers drop the same
    requests."""
    jt, js, pt, ps, _ = _pair(capacity_factor=0.2)
    akb = _anchors(1, seed=4)
    _, jl = jt.train_steps(js, akb, jax.random.PRNGKey(1))
    _, pl = pt.train_steps(ps, akb)
    assert pt.overflow_total == jt.overflow_total > 0
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-6)


@pytest.mark.parametrize("policy", ["warn", "silent", "raise", "grow"])
def test_overflow_policies(policy, caplog):
    dg = _graphs()[1]
    mesh = Mesh(4, "cpu")
    pt = PartitionedNALPTrainer(
        LinkPredictionGNN(GNNEncoder(D, HID, OUT), LinkPredictionDecoder()),
        PartitionedGraph.build(dg, mesh), mesh,
        NALPTrainerConfig(fanouts=FANOUTS, num_random_negs=R),
        capacity_factor=0.2, overflow_policy=policy)
    state = pt.init_state(0)
    akb = _anchors(1, seed=4)
    with caplog.at_level(logging.WARNING):
        if policy == "raise":
            with pytest.raises(RuntimeError, match="capacity"):
                pt.train_steps(state, akb)
            return
        _, losses = pt.train_steps(state, akb)
    assert np.isfinite(losses.numpy()).all()
    assert pt.overflow_total > 0
    warned = any("dropped" in rec.message for rec in caplog.records)
    assert warned == (policy in ("warn", "grow"))
    assert pt.capacity_factor == (0.4 if policy == "grow" else 0.2)


def test_fit_runs_on_four_shards():
    pt, state = _trainer(4)
    state, metrics = pt.fit(state, np.arange(N), np.arange(0, N, 7),
                            batch_size=B, num_epochs=1,
                            val_every_n_batches=4, num_val_batches=2,
                            log_every=0)
    assert state.step == N // B
    assert 0.0 <= metrics["mrr"] <= 1.0 and "hits@10" in metrics
    with pytest.raises(ValueError, match="divide"):
        pt.fit(state, np.arange(N), np.arange(8), batch_size=30)


@pytest.mark.parametrize("case", ["weighted", "label_edges"])
def test_unported_options_raise(case):
    """Every option is ported now: label-edge features on the partitioned
    graph shard with their CSRs (their parity tests are in
    tests/test_torch_dist_label_edges.py), and the weighted draws need a
    graph with edge weights. (cached_hop, int8 rows, labels and
    with_tabularized: tests/test_torch_dist_tabularized.py,
    test_torch_dist_quantized.py and test_torch_dist_nc.py.)"""
    src, dst, x, _ = _arrays()
    mesh = Mesh(4, "cpu")
    model = LinkPredictionGNN(GNNEncoder(D, HID, OUT),
                              LinkPredictionDecoder())
    if case == "label_edges":
        dg = DeviceGraph.from_hetero(
            HeteroGraph.homogeneous(src=src, dst=dst, num_nodes=N,
                                    node_features=x),
            supervision_edges=np.stack([src, dst]), device="cpu",
            supervision_edge_features=np.arange(
                2 * len(src), dtype=np.float32).reshape(-1, 2))
        pg = PartitionedGraph.build(dg, mesh)
        assert pg.hard_edge_feats is None
        got = torch.cat([f[:int(ip[-1])] for f, ip in
                         zip(pg.sup_edge_feats, pg.sup_indptr)])
        assert torch.equal(got, dg.sup_edge_features)
        return
    # weighted draws are ported (tests/test_torch_weighted_sampling.py):
    # a graph without edge weights raises the reference's ValueError
    pg = PartitionedGraph.build(_graphs()[1], mesh)
    cfg = NALPTrainerConfig(fanouts=FANOUTS, sampling_method="weighted")
    with pytest.raises(ValueError, match="with edge weights"):
        PartitionedNALPTrainer(model, pg, mesh, cfg)


def test_bad_configs_raise():
    mesh = Mesh(4, "cpu")
    pg = PartitionedGraph.build(_graphs()[1], mesh)
    model = LinkPredictionGNN(GNNEncoder(D, HID, OUT),
                              LinkPredictionDecoder())
    with pytest.raises(ValueError, match="num_random_negs"):
        PartitionedNALPTrainer(model, pg, mesh, NALPTrainerConfig(
            fanouts=FANOUTS, num_random_negs=7))
    with pytest.raises(ValueError, match="retrieval"):
        PartitionedNALPTrainer(model, pg, mesh, NALPTrainerConfig(
            fanouts=FANOUTS, global_candidate_pool=True, loss_type="margin"))
    with pytest.raises(ValueError, match="overflow_policy"):
        PartitionedNALPTrainer(model, pg, mesh, NALPTrainerConfig(
            fanouts=FANOUTS), overflow_policy="drop")
    with pytest.raises(ValueError, match="mesh"):
        PartitionedNALPTrainer(model, pg, Mesh(2, "cpu"),
                               NALPTrainerConfig(fanouts=FANOUTS))
    pt = PartitionedNALPTrainer(model, pg, mesh, NALPTrainerConfig(
        fanouts=FANOUTS, num_random_negs=R))
    state = pt.init_state(0)
    with pytest.raises(ValueError, match="divisible"):
        pt.train_steps(state, np.zeros((1, 30), np.int32))


class _Sink:
    def __init__(self):
        self.ids, self.embs, self.flushed = [], [], 0

    def add_embeddings(self, ids, emb):
        self.ids.append(np.asarray(ids))
        self.embs.append(np.asarray(emb))

    def flush(self):
        self.flushed += 1


@pytest.fixture(scope="module")
def fresh_pair():
    """Both trainers on the same untrained params (4 shards)."""
    jt, js, pt, _, _ = _pair()
    return jt, js, pt


@pytest.mark.parametrize("batch_size", [64, 100])
def test_run_partitioned_inference_matches_jax(fresh_pair, batch_size):
    """Every node through each trainer's encode_batch into an exporter (100:
    a tail batch of 12 real ids, padded), from the same params; the rows are
    the port's encode_batch's."""
    jt, js, pt = fresh_pair
    want, got = _Sink(), _Sink()
    n_want = jax_run_partitioned_inference(
        jt, js.params, N, want, JaxInferenceConfig(batch_size=batch_size))
    n_got = run_partitioned_inference(
        pt, N, got, InferenceConfig(batch_size=batch_size), device="cpu")
    assert n_got == n_want == N and got.flushed == 1
    assert all(np.array_equal(a, b) for a, b in zip(got.ids, want.ids))
    g, w = np.concatenate(got.embs), np.concatenate(want.embs)
    assert g.shape == w.shape == (N, OUT) and g.dtype == np.float32
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
    ids = np.concatenate(got.ids)
    assert np.array_equal(g, pt.encode_batch(ids).numpy())


def test_run_partitioned_inference_options_raise(fresh_pair):
    """node_type= is ported (the typed trainer's encode_batch:
    tests/test_torch_dist_hetero.py); a mesh on another device raises."""
    pt = fresh_pair[2]
    with pytest.raises(ValueError, match="mesh lives on"):
        run_partitioned_inference(pt, N, _Sink(), device="meta")
