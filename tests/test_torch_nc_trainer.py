"""The port's sampled node-classification trainer
(gigl_tpu_torch.training.trainer.NodeClassificationTrainer) against the
JAX reference on the CPU, where every kernel runs its plain twin: a
Cora-shaped graph (``gigl_tpu.data.mocking.cora_like``: 300 nodes, 16
features, 4 classes, undirected), GraphSAGE (fanouts (4, 3); K1, K3, K4 /
K4b on the card) and GAT (3 layers, 2 heads, fanouts (3, 3, 2); K7 / K7b
on the card), batch 32.

Labels, sampled blocks and batches are bit-equal. fp32 losses over 20
steps of Adam within 1e-4 relative (the same math, sums in another order);
``evaluate`` and ``fit`` give the same accuracies.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigl_tpu.data.mocking import cora_like
from gigl_tpu.models.encoders import GNNEncoder as RefGNNEncoder
from gigl_tpu.training.dataset import DeviceGraph as RefDeviceGraph
from gigl_tpu.training.trainer import (
    NodeClassificationTrainer as RefTrainer,
    NodeClassificationTrainerConfig as RefConfig,
)
from gigl_tpu_torch.convert import adam_state_from_optax, params_from_flax
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.models.encoders import GNNEncoder
from gigl_tpu_torch.training.dataset import (
    DeviceGraph,
    NodeClassificationBatch,
)
from gigl_tpu_torch.training.trainer import (
    NodeClassificationTrainer,
    NodeClassificationTrainerConfig,
)

torch.set_num_threads(1)

N, D, C, B, HID = 300, 16, 4, 32, 16
OPT = {"learning_rate": "0.01"}
MODELS = {"graphsage": (2, (4, 3), None),
          "gat": (3, (3, 3, 2), {"heads": 2})}


def _graphs():
    jg = cora_like(num_nodes=N, num_classes=C, dim=D, avg_degree=6, seed=3)
    nt = jg.metadata.node_types[0]
    coo = jg.edges[jg.metadata.edge_types[0]]
    pg = HeteroGraph.homogeneous(
        coo[0], coo[1], num_nodes=N,
        node_features=np.asarray(jg.node_features[nt]),
        node_labels=jg.node_labels[nt])
    return jg, pg


def _pair(conv, fanouts=None):
    layers, default_fanouts, kw = MODELS[conv]
    cfg = dict(fanouts=fanouts or default_fanouts, seed=2)
    jg, pg = _graphs()
    jt = RefTrainer(RefGNNEncoder(hid_dim=HID, out_dim=C, num_layers=layers,
                                  conv=conv, conv_kwargs=kw),
                    RefDeviceGraph.from_hetero(jg), RefConfig(**cfg),
                    optimizer_args=OPT)
    js = jt.init_state(jax.random.PRNGKey(0), batch_size=B)
    pt = NodeClassificationTrainer(
        GNNEncoder(D, HID, C, num_layers=layers, conv=conv, conv_kwargs=kw),
        DeviceGraph.from_hetero(pg, device="cpu"),
        NodeClassificationTrainerConfig(**cfg), optimizer_args=OPT,
        device="cpu")
    ps = pt.init_state(params=params_from_flax(
        jax.tree_util.tree_map(np.asarray, js.params)))
    return jt, js, pt, ps


def _nodes(k, seed=1):
    return np.random.default_rng(seed).integers(0, N, (k, B))


def test_labels_and_sampled_blocks_bit_equal():
    jt, _, pt, _ = _pair("gat")
    np.testing.assert_array_equal(pt.graph.node_labels.numpy(),
                                  np.asarray(jt.graph.node_labels))
    assert pt.graph.node_labels.dtype == torch.int32
    # jit: one compile instead of an eager one per op
    sample = jax.jit(lambda g, n: g.sample_hop_blocks(n, jt.cfg.fanouts,
                                                      seed=jt.cfg.seed))
    for nodes in _nodes(3):
        want = sample(jt.graph, jnp.asarray(nodes, jnp.int32))
        got = pt.graph.sample_hop_blocks(torch.as_tensor(nodes),
                                         pt.cfg.fanouts, seed=pt.cfg.seed)
        for g, w in zip(got.node_ids + got.masks,
                        want.node_ids + want.masks):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    batch = NodeClassificationBatch(
        nodes=torch.arange(4, dtype=torch.int32),
        labels=pt.graph.node_labels[:4], mask=torch.ones(4, dtype=torch.bool))
    assert batch.labels.shape == (4,)


@pytest.mark.parametrize("conv", sorted(MODELS))
def test_twenty_step_trajectory_and_evaluate_match_jax(conv):
    jt, js, pt, ps = _pair(conv)
    nkb = _nodes(20)
    want = []
    for k in range(20):
        js, loss = jt._train_step(jt.graph, js, jnp.asarray(nkb[k],
                                                             jnp.int32),
                                  jax.random.PRNGKey(k))
        want.append(float(loss))
    got = []
    for k in range(20):
        ps, loss = pt.train_step(ps, nkb[k])
        got.append(float(loss))
    assert ps.step == 20
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert want[-1] < want[0]
    nodes = np.arange(N)[::3]                  # 100 nodes: a padded tail
    assert pt.evaluate(nodes, B) == jt.evaluate(js.params, nodes, B)
    logits = pt.predict_batch(nodes[:B])
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jt.predict_batch(js.params, nodes[:B])),
        rtol=0, atol=1e-4 * float(logits.abs().max()))


def test_fit_matches_jax():
    jt, js, pt, ps = _pair("graphsage")
    kw = dict(batch_size=B, num_epochs=4, early_stop_patience=1, log_every=0)
    nodes = np.arange(N)
    _, want = jt.fit(js, nodes[:240], nodes[240:], **kw)
    _, got = pt.fit(ps, nodes[:240], nodes[240:], **kw)
    assert got == want


@pytest.mark.parametrize("conv", ["graphsage", "gcn", "gin", "gat", "gatv2",
                                  "transformer"])
def test_converted_state_covers_every_conv(conv):
    """params_from_flax and adam_state_from_optax map a node-classification
    encoder's parameters and Adam moments for every ported conv."""
    kw = {"heads": 2} if conv in ("gat", "gatv2", "transformer") else None
    jg, pg = _graphs()
    jt = RefTrainer(RefGNNEncoder(hid_dim=HID, out_dim=C, conv=conv,
                                  conv_kwargs=kw),
                    RefDeviceGraph.from_hetero(jg), RefConfig(fanouts=(3, 2)),
                    optimizer_args=OPT)
    js = jt.init_state(jax.random.PRNGKey(0), batch_size=8)
    pt = NodeClassificationTrainer(
        GNNEncoder(D, HID, C, conv=conv, conv_kwargs=kw),
        DeviceGraph.from_hetero(pg, device="cpu"),
        NodeClassificationTrainerConfig(fanouts=(3, 2)), device="cpu")
    params = jax.tree_util.tree_map(np.asarray, js.params)
    ps = pt.init_state(params=params_from_flax(params))
    state = adam_state_from_optax(jax.tree_util.tree_map(np.asarray,
                                                         js.opt_state),
                                  pt.model)
    assert len(state) == len(list(pt.model.parameters()))
    ps.optimizer.load_state_dict({
        "state": state,
        "param_groups": ps.optimizer.state_dict()["param_groups"]})
    for name, p in pt.model.named_parameters():
        assert p.shape == params_from_flax(params)[name].shape, name


def test_unlabeled_graph_raises():
    _, pg = _graphs()
    pg.node_labels.clear()
    with pytest.raises(ValueError, match="no node labels"):
        NodeClassificationTrainer(GNNEncoder(D, HID, C),
                                  DeviceGraph.from_hetero(pg, device="cpu"),
                                  NodeClassificationTrainerConfig(),
                                  device="cpu")
