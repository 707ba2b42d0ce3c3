"""The port's supervised link classification (gigl_tpu_torch.training.
link_task) against the JAX reference: the endpoint draws bit-equal,
predict_batch, a 20-step trajectory at dropout 0, evaluate and fit, the
head's parameters converted by params_from_flax. Small sizes (N 150,
fanouts (3, 2), batch 16, hidden 8) on the CPU, where the kernels run
their plain twins.

Tolerances: draws bit-equal; fp32 logits within 1e-5 of their scale;
first-step gradients within 1e-4 of each parameter's gradient scale
(measured ~1e-6); 20-step losses within 1e-3 relative (the same math
summed in another order, drifting through Adam), as
tests/test_torch_training.py's; accuracies equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigl_tpu.graph.csr import HeteroGraph as JaxHeteroGraph
from gigl_tpu.models.encoders import GNNEncoder as JaxGNNEncoder
from gigl_tpu.training.dataset import DeviceGraph as JaxDeviceGraph
from gigl_tpu.training.link_task import (
    EdgeClassifierHead as JaxHead,
    LinkClassificationModel as JaxModel,
    LinkClassificationTrainer as JaxTrainer,
    LinkClassificationTrainerConfig as JaxConfig,
)
from gigl_tpu_torch.convert import params_from_flax
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.models.encoders import GNNEncoder
from gigl_tpu_torch.training.dataset import DeviceGraph
from gigl_tpu_torch.training.link_task import (
    EdgeClassifierHead,
    LinkClassificationModel,
    LinkClassificationTrainer,
    LinkClassificationTrainerConfig,
)

torch.set_num_threads(1)

N, E, D, HID, OUT, C, B = 150, 1200, 8, 8, 6, 3, 16
L = 240                       # labelled edges
OPT = {"learning_rate": "0.01"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    x = rng.normal(size=(N, D)).astype(np.float32)
    pick = rng.choice(E, L, replace=False)
    edges = np.stack([src[pick], dst[pick]])
    # labels a function of the endpoints' features, so the task is
    # learnable
    labels = (np.sign(x[edges[0], 0] * x[edges[1], 1]) + 1).astype(np.int64)
    labels = np.where(np.abs(x[edges[0], 2]) > 1.2, 1, labels) % C
    return src, dst, x, edges, labels


def _pair(combine="hadamard", jk_mode=None, seed=4):
    src, dst, x, edges, labels = _data()
    cfg = dict(fanouts=(3, 2), seed=seed)
    enc_kw = dict(jk_mode=jk_mode, linear_layer=jk_mode is not None)
    jt = JaxTrainer(
        JaxModel(encoder=JaxGNNEncoder(hid_dim=HID, out_dim=OUT, **enc_kw),
                 head=JaxHead(num_classes=C, hidden_dim=HID,
                              combine=combine)),
        JaxDeviceGraph.from_hetero(JaxHeteroGraph.homogeneous(
            src=src, dst=dst, num_nodes=N, node_features=x)),
        edges, labels, JaxConfig(**cfg), optimizer_args=OPT)
    js = jt.init_state(jax.random.PRNGKey(0), batch_size=B)
    pt = LinkClassificationTrainer(
        LinkClassificationModel(
            GNNEncoder(D, HID, OUT, **enc_kw),
            EdgeClassifierHead(OUT, C, hidden_dim=HID, combine=combine)),
        DeviceGraph.from_hetero(HeteroGraph.homogeneous(
            src=src, dst=dst, num_nodes=N, node_features=x), device="cpu"),
        edges, labels, LinkClassificationTrainerConfig(**cfg),
        optimizer_args=OPT, device="cpu")
    ps = pt.init_state(params=params_from_flax(_np(js.params)))
    return jt, js, pt, ps


def _batches(k, seed=1):
    return np.random.default_rng(seed).integers(0, L, (k, B))


def test_endpoint_draws_bit_equal():
    jt, _, pt, _ = _pair()
    ids = np.random.default_rng(2).integers(0, N, 40)
    jf, jm = jax.jit(jt._encode_inputs)(jt.graph, jnp.asarray(ids,
                                                                jnp.int32))
    pf, pm = pt._encode_inputs(pt.graph, torch.as_tensor(ids,
                                                         dtype=torch.int32))
    for a, b in zip(pf, jf):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(pm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(pt.edges.numpy(), np.asarray(jt.edges))
    np.testing.assert_array_equal(pt.labels.numpy(), np.asarray(jt.labels))


@pytest.mark.parametrize("combine,jk_mode", [("hadamard", None),
                                             ("concat", "cat")])
def test_predict_batch_and_first_step_gradients(combine, jk_mode):
    jt, js, pt, _ = _pair(combine, jk_mode)
    src, dst, *_ = _data()
    s, d = src[:24], dst[:24]
    want = np.asarray(jt.predict_batch(js.params, s, d))
    got = pt.predict_batch(s, d)
    assert got.shape == (24, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    idx = _batches(1)[0]
    edges, labels = jt.edges, jt.labels

    def jloss(p):
        sj, dj = edges[0, idx], edges[1, idx]
        logits = jt._logits_impl(jt.graph, p, sj, dj, True,
                                 jax.random.PRNGKey(0))
        lz = jax.nn.logsumexp(logits, -1)
        ll = jnp.take_along_axis(logits, labels[idx][:, None], -1)[:, 0]
        return jnp.mean(lz - ll)

    jl, jg = jax.value_and_grad(jloss)(js.params)
    loss = pt.loss(idx)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want_g = params_from_flax(_np(jg))
    for n, p in pt.model.named_parameters():
        scale = float(want_g[n].abs().max())
        assert scale > 0, n
        np.testing.assert_allclose(p.grad.numpy(), want_g[n].numpy(),
                                   rtol=0, atol=1e-4 * scale, err_msg=n)


def test_twenty_step_trajectory_matches_jax():
    jt, js, pt, ps = _pair()
    rng = jax.random.PRNGKey(1)
    want = []
    for b in _batches(20):
        rng, sub = jax.random.split(rng)
        js, loss = jt.train_step(js, b, sub)
        want.append(float(loss))
    got = []
    for b in _batches(20):
        ps, loss = pt.train_step(ps, b)
        got.append(float(loss))
    assert ps.step == 20
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert np.isfinite(want).all() and want[-5:].mean() < want[:5].mean()
    # evaluate after training: the same accuracy over every labelled edge
    idx = np.arange(L)
    assert pt.evaluate(idx, batch_size=64) == jt.evaluate(js.params, idx,
                                                          batch_size=64)


def test_fit_matches_jax():
    jt, js, pt, ps = _pair(seed=6)
    kw = dict(batch_size=B, num_epochs=3, early_stop_patience=1,
              log_every=0)
    idx = np.arange(L)
    _, want = jt.fit(js, idx[:180], idx[180:], **kw)
    _, got = pt.fit(ps, idx[:180], idx[180:], **kw)
    assert got == want and 0.0 < got["accuracy"] <= 1.0


def test_device_rules_and_batch_norm_refusal():
    """CUDA unless device="cpu" (a raise without CUDA); a train step over a
    batch-norm encoder refused, as the reference's raises; eval runs."""
    src, dst, x, edges, labels = _data()
    g = DeviceGraph.from_hetero(HeteroGraph.homogeneous(
        src=src, dst=dst, num_nodes=N, node_features=x), device="cpu")
    model = LinkClassificationModel(GNNEncoder(D, HID, OUT, batchnorm=True),
                                    EdgeClassifierHead(OUT, C))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LinkClassificationTrainer(model, g, edges, labels,
                                      LinkClassificationTrainerConfig())
    t = LinkClassificationTrainer(model, g, edges, labels,
                                  LinkClassificationTrainerConfig(
                                      fanouts=(3, 2)), device="cpu")
    state = t.init_state(0)
    with pytest.raises(ValueError, match="batch-norm encoder"):
        t.train_step(state, np.arange(B))
    assert t.predict_batch(src[:5], dst[:5]).shape == (5, C)
    with pytest.raises(ValueError, match="unknown combine"):
        EdgeClassifierHead(OUT, C, combine="sum")
