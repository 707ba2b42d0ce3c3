"""The port's partitioned node-classification trainer (gigl_tpu_torch.
training.dist_sampled PartitionedNodeClassificationTrainer) against the JAX
reference's on the CPU, where every kernel runs its plain twin. The toy is
the multi-chip dryrun's: 512 nodes, 4,096 edges, D 16 (and an odd D 13),
4 classes, fanouts (5, 3), GraphSAGE hidden 32, batch 64, capacity factor
8, at 1 and 4 shards, live and cached_hop, fp32 and int8 rows.

Tolerances: the first loss (the mean of the per-shard mean cross
entropies) within 1e-5 relative of the reference's train_steps on the same
params and nodes (measured up to 1e-7), 3-step trajectories within rtol
1e-5 (the same math, sums in another order, through Adam); evaluate's
accuracy EQUAL (an argmax count; measured equal); predict_batch's logits
within 1e-5 of their scale (measured 1.8e-7); the overflow counts EQUAL; a
short fit on a clustered graph learns (val accuracy above 0.6, as the
reference's test asks); run_partitioned_inference's rows within 1e-5 of
the scale, the exported ids equal.
"""

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
from gigl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gigl_tpu.training.dataset import DeviceGraph as JaxDeviceGraph
from gigl_tpu.training.dist_sampled import (
    PartitionedGraph as JaxPartitionedGraph,
    PartitionedNodeClassificationTrainer as JaxPartitionedNCTrainer,
)
from gigl_tpu.training.trainer import (
    NodeClassificationTrainerConfig as JaxNCConfig,
)
from gigl_tpu_torch.convert import params_from_flax
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.inference.inferencer import (
    InferenceConfig,
    run_partitioned_inference,
)
from gigl_tpu_torch.models.encoders import GNNEncoder
from gigl_tpu_torch.parallel.mesh import Mesh
from gigl_tpu_torch.training.dataset import DeviceGraph
from gigl_tpu_torch.training.dist_sampled import (
    PartitionedGraph,
    PartitionedNodeClassificationTrainer,
)
from gigl_tpu_torch.training.trainer import NodeClassificationTrainerConfig

torch.set_num_threads(1)

N, E, HID, C, B = 512, 4096, 32, 4, 64
FANOUTS = (5, 3)
OPT = {"learning_rate": "0.01"}


def _graphs(d=16, seed=0, n=N, e=E, src=None, dst=None, x=None,
            labels=None):
    rng = np.random.default_rng(seed)
    if src is None:
        src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
        x = rng.normal(size=(n, d)).astype(np.float32)
        labels = rng.integers(0, C, n)
    kw = dict(src=src, dst=dst, num_nodes=n, node_features=x,
              node_labels=labels)
    return (JaxDeviceGraph.from_hetero(JaxHeteroGraph.homogeneous(**kw)),
            DeviceGraph.from_hetero(HeteroGraph.homogeneous(**kw),
                                    device="cpu"))


def _pair(num_shards, cached=False, quantize=False, d=16, graphs=None,
          capacity_factor=8.0, seed=7):
    """A JAX and a port partitioned NC trainer over the same graph and
    params: (jax trainer, jax state, port trainer, port state)."""
    jdg, dg = graphs or _graphs(d)
    jm, mesh = jax_make_mesh(num_shards), Mesh(num_shards, "cpu")
    cfg = dict(fanouts=FANOUTS, seed=seed, cached_hop=cached)
    jt = JaxPartitionedNCTrainer(
        JaxGNNEncoder(hid_dim=HID, out_dim=C, dropout=0.0),
        JaxPartitionedGraph.build(jdg, jm, quantize_features=quantize), jm,
        JaxNCConfig(**cfg), optimizer_args=OPT,
        capacity_factor=capacity_factor, overflow_policy="silent")
    js = jt.init_state(jax.random.PRNGKey(0), B)
    pt = PartitionedNodeClassificationTrainer(
        GNNEncoder(dg.node_features.shape[1], HID, C),
        PartitionedGraph.build(dg, mesh, quantize_features=quantize), mesh,
        NodeClassificationTrainerConfig(**cfg), optimizer_args=OPT,
        capacity_factor=capacity_factor, overflow_policy="silent")
    ps = pt.init_state(params=params_from_flax(
        jax.tree_util.tree_map(np.asarray, js.params)))
    return jt, js, pt, ps


CASES = [(1, False, False, 16), (4, False, False, 16), (4, False, True, 13),
         (1, True, False, 16), (4, True, False, 16), (1, True, True, 16),
         (4, True, True, 13)]


@pytest.mark.parametrize("num_shards,cached,quantize,d", CASES)
def test_nc_trainer_matches_jax(num_shards, cached, quantize, d):
    """Untrained: predict_batch and evaluate (70 nodes: cut to a shard
    multiple); then the first loss and a 3-step trajectory, zero
    overflow, and evaluate on the trained weights."""
    jt, js, pt, ps = _pair(num_shards, cached, quantize, d)
    ids = (np.arange(50, dtype=np.int32) * 9) % N
    w = np.asarray(jt.predict_batch(js.params, ids))
    g = pt.predict_batch(ids).numpy()
    assert g.shape == (50, C)
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
    batches = [np.arange(64, dtype=np.int32),
               np.arange(100, 170, dtype=np.int32)]
    assert pt.evaluate(batches) == jt.evaluate(js.params, batches)
    nodes = np.random.default_rng(3).integers(0, N, (3, B)).astype(np.int32)
    js, jl = jt.train_steps(js, nodes, jax.random.PRNGKey(1))
    ps, pl = pt.train_steps(ps, nodes)
    jl, pl = np.asarray(jl), pl.numpy()
    assert ps.step == 3
    assert abs(pl[0] - jl[0]) <= 1e-5 * abs(jl[0])
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pt.overflow_total == 0 == jt.overflow_total
    assert pt.evaluate(batches) == jt.evaluate(js.params, batches)


def test_loss_is_the_mean_of_per_shard_means():
    """The 4-shard loss is the mean of each shard's mean cross entropy
    (one shard's trainer over each slice), not the global mean."""
    graphs = _graphs()
    _, _, pt, _ = _pair(4, graphs=graphs)
    params = {k: v.clone() for k, v in pt.model.state_dict().items()}
    nodes = np.random.default_rng(8).integers(0, N, B).astype(np.int32)
    with torch.no_grad():
        got = float(pt.loss_and_overflow(nodes)[0])
    _, _, one, _ = _pair(1, graphs=graphs)
    one.init_state(params=params)
    with torch.no_grad():
        per = [float(one.loss_and_overflow(part)[0])
               for part in nodes.reshape(4, -1)]
    assert abs(got - np.mean(per)) <= 1e-6 * abs(got)


def test_overflow_counts_match_jax():
    """A capacity factor far too small: both trainers drop the same tree
    and label requests and mask the dropped labels out of the loss."""
    jt, js, pt, ps = _pair(4, capacity_factor=0.3)
    nodes = np.random.default_rng(4).integers(0, N, (1, B)).astype(np.int32)
    _, jl = jt.train_steps(js, nodes, jax.random.PRNGKey(1))
    _, pl = pt.train_steps(ps, nodes)
    assert pt.overflow_total == jt.overflow_total > 0
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5)


def _clustered():
    """The reference's fit toy: 128 nodes in 4 clusters, label = cluster,
    the cluster one-hot added to the features."""
    n = 128
    rng = np.random.default_rng(5)
    cluster = np.arange(n) % C
    src, dst = [], []
    for c in range(C):
        members = np.where(cluster == c)[0]
        src.append(rng.choice(members, 600))
        dst.append(rng.choice(members, 600))
    x = rng.normal(size=(n, 8)).astype(np.float32)
    x[:, :C] += 2.0 * np.eye(C, dtype=np.float32)[cluster]
    return (np.concatenate(src), np.concatenate(dst), x, cluster,
            rng.permutation(n))


@pytest.mark.parametrize("cached", [False, True], ids=["live", "cached"])
def test_fit_learns_and_predicts(cached):
    src, dst, x, labels, perm = _clustered()
    _, dg = _graphs(n=128, src=src, dst=dst, x=x, labels=labels)
    mesh = Mesh(4, "cpu")
    pt = PartitionedNodeClassificationTrainer(
        GNNEncoder(8, HID, C), PartitionedGraph.build(dg, mesh), mesh,
        NodeClassificationTrainerConfig(fanouts=FANOUTS, cached_hop=cached),
        optimizer_args=OPT, capacity_factor=8.0)
    state = pt.init_state(0)
    state, metrics = pt.fit(state, perm[:96], perm[96:], batch_size=32,
                            num_epochs=8, early_stop_patience=8, log_every=0)
    assert metrics["accuracy"] > 0.6, metrics
    assert state.step == 8 * 3
    assert pt.predict_batch(np.arange(40)).shape == (40, C)
    # a val set smaller than the shard count wraps up to one per shard
    _, small = pt.fit(state, perm[:96], perm[96:99], batch_size=32,
                      num_epochs=1, log_every=0)
    assert small["accuracy"] == pt.evaluate([np.resize(perm[96:99], 4)])
    with pytest.raises(ValueError, match="divide"):
        pt.fit(state, perm[:96], perm[96:], batch_size=30)
    with pytest.raises(ValueError, match="empty"):
        pt.fit(state, perm[:96], perm[:0], batch_size=32)


def test_requires_labels():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 64, 300), rng.integers(0, 64, 300)
    dg = DeviceGraph.from_hetero(HeteroGraph.homogeneous(
        src=src, dst=dst, num_nodes=64,
        node_features=rng.normal(size=(64, 8)).astype(np.float32)),
        device="cpu")
    mesh = Mesh(4, "cpu")
    with pytest.raises(ValueError, match="labels"):
        PartitionedNodeClassificationTrainer(
            GNNEncoder(8, 16, C), PartitionedGraph.build(dg, mesh), mesh,
            NodeClassificationTrainerConfig())


class _Sink:
    def __init__(self):
        self.ids, self.embs, self.flushed = [], [], 0

    def add_embeddings(self, ids, emb):
        self.ids.append(np.asarray(ids))
        self.embs.append(np.asarray(emb))

    def flush(self):
        self.flushed += 1


@pytest.mark.parametrize("cached", [False, True], ids=["live", "cached"])
def test_run_partitioned_inference_through_predict(cached):
    """Every node through each NC trainer's encode_batch (batch 100: a
    padded tail) into an exporter: the reference's rows."""
    jt, js, pt, _ = _pair(4, cached, quantize=True)
    want, got = _Sink(), _Sink()
    n_want = jax_run_partitioned_inference(
        jt, js.params, N, want, JaxInferenceConfig(batch_size=100))
    n_got = run_partitioned_inference(pt, N, got,
                                      InferenceConfig(batch_size=100),
                                      device="cpu")
    assert n_got == n_want == N and got.flushed == 1
    assert all(np.array_equal(a, b) for a, b in zip(got.ids, want.ids))
    g, w = np.concatenate(got.embs), np.concatenate(want.embs)
    assert g.shape == (N, C)
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
