"""The port's graph-sharded full-batch trainer (gigl_tpu_torch.training.
sharded_full_batch) against the JAX reference's ShardedFullBatchTrainer on
the virtual CPU mesh, on the CPU, where K18 ring_spmm runs its plain twin.
The toy is the reference test's: 150 nodes, 1,200 edges, D 12, 5 classes,
hidden 16, two layers; the port's parameters are the reference's, carried
over with convert.sharded_params_from_jax.

Tolerances: _gcn_norm and the padded rows BIT-EQUAL; logits within 1e-5
of their scale (measured up to 2.2e-7); the first step's loss within 1e-6
relative and every parameter's gradient within 1e-5 of its scale (jax.
value_and_grad; sums in another order); 10-step Adam trajectories (lr
0.01) within rtol 1e-5 (measured up to 2.1e-6); accuracy and fit's metrics
equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigl_tpu.losses.losses import cross_entropy_loss as jax_ce
from gigl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gigl_tpu.training import sharded_full_batch as jax_sfb
from gigl_tpu_torch.convert import sharded_params_from_jax
from gigl_tpu_torch.parallel.mesh import Mesh, make_mesh
from gigl_tpu_torch.training import sharded_full_batch as sfb

torch.set_num_threads(1)

OPT = {"learning_rate": "0.01"}
STEPS = 10


def _toy(n=150, e=1200, d=12, c=5, seed=0):
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    x = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, c, n)
    masks = np.zeros((3, n), bool)
    masks[rng.integers(0, 3, n), np.arange(n)] = True
    return edges, x, labels, masks


def _pair(conv, num_shards=4, seed=0, **cfg):
    """A JAX and a port trainer on the same toy and params: (jax trainer,
    jax state, port trainer, port state)."""
    edges, x, labels, masks = _toy(seed=seed)
    kw = dict(conv=conv, hid_dim=16, out_dim=5, **cfg)
    jt = jax_sfb.ShardedFullBatchTrainer(
        edges, x, labels, *masks, jax_make_mesh(num_shards),
        jax_sfb.ShardedFullBatchConfig(**kw), optimizer_args=OPT)
    js = jt.init_state(jax.random.PRNGKey(seed))
    pt = sfb.ShardedFullBatchTrainer(
        edges, x, labels, *masks, Mesh(num_shards, "cpu"),
        sfb.ShardedFullBatchConfig(**kw), optimizer_args=OPT)
    ps = pt.init_state(params=sharded_params_from_jax(
        jax.tree_util.tree_map(np.asarray, js.params)))
    return jt, js, pt, ps


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("seed", [0, 3])
def test_gcn_norm_bit_equal(seed):
    edges = _toy(seed=seed)[0]
    for got, want in zip(sfb._gcn_norm(edges, 150),
                         jax_sfb._gcn_norm(edges, 150)):
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)


@pytest.mark.parametrize("num_shards", [1, 4, 8])
@pytest.mark.parametrize("conv", ["gcn", "graphsage"])
def test_logits_match_jax(conv, num_shards):
    jt, js, pt, _ = _pair(conv, num_shards)
    want = np.asarray(jt.logits(js.params))
    got = pt.logits()
    assert got.shape == (150, 5)
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("conv", ["gcn", "graphsage"])
def test_padded_rows_match_jax(conv):
    jt, _, pt, _ = _pair(conv)      # 150 rows over 4 shards: 2 padded
    assert pt.n_pad == jt.n_pad == 152
    assert np.array_equal(pt.x.numpy(), np.asarray(jt.x))
    assert np.array_equal(pt.labels.numpy(), np.asarray(jt.labels))
    for k in ("train", "val", "test"):
        assert np.array_equal(pt.masks[k].numpy(), np.asarray(jt.masks[k]))
    if conv == "gcn":
        assert np.array_equal(pt.inv_self.numpy(), np.asarray(jt.inv_self))
        assert not pt.inv_self[150:].any()
    else:
        assert pt.inv_self is None and jt.inv_self is None


@pytest.mark.parametrize("conv", ["gcn", "graphsage"])
def test_first_step_gradients_match_jax(conv):
    jt, js, pt, _ = _pair(conv, seed=1)

    def loss_fn(p):
        s, c = jax_ce(jt._forward(p, jt.x), jt.labels,
                      mask=jt.masks["train"])
        return s / jnp.maximum(c.astype(jnp.float32), 1.0)

    jl, jg = jax.value_and_grad(loss_fn)(js.params)
    loss = pt.loss()
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-6 * abs(float(jl))
    want = sharded_params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    got = dict(pt.model.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        assert _rel(got[name].grad.numpy(), g.numpy()) <= 1e-5, name


@pytest.mark.parametrize("conv", ["gcn", "graphsage"])
def test_trajectory_matches_jax(conv):
    jt, js, pt, ps = _pair(conv, seed=2)
    jl, pl = [], []
    for _ in range(STEPS):
        js, loss = jt._train_step(js, jt.x, jt.labels, jt.masks["train"])
        jl.append(float(loss))
        ps, loss = pt.train_step(ps)
        pl.append(float(loss))
    assert ps.step == STEPS
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=0)
    assert pl[-1] < pl[0]
    want = sharded_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          js.params))
    for name, p in pt.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("conv", ["gcn", "graphsage"])
def test_accuracy_and_fit_match_jax(conv):
    jt, js, pt, ps = _pair(conv, num_epochs=20, eval_every=5,
                           early_stop_patience=2)
    for split in ("train", "val", "test"):
        assert pt.accuracy(split) == jt.accuracy(js.params, split)
    js, jm = jt.fit(js)
    ps, pm = pt.fit(ps)
    assert pm == jm
    assert set(pm) == {"accuracy", "test_accuracy"}


def test_init_params_draws_scaled_normals():
    edges, x, labels, masks = _toy()
    pt = sfb.ShardedFullBatchTrainer(
        edges, x, labels, *masks, Mesh(4, "cpu"),
        sfb.ShardedFullBatchConfig(conv="graphsage", hid_dim=64, out_dim=5))
    a = {k: v.clone() for k, v in pt.init_params(0).items()}
    b = {k: v.clone() for k, v in pt.init_params(0).items()}
    c = pt.init_params(1)
    assert set(a) == {f"layers.{i}.{k}" for i in (0, 1)
                      for k in ("w_self", "w_nbr", "b")}
    for k in a:
        assert torch.equal(a[k], b[k])
        if k.endswith(".b"):
            assert not a[k].any()
        else:
            assert not torch.equal(a[k], c[k])
            fan_in = a[k].shape[0]
            assert abs(float(a[k].std()) * np.sqrt(fan_in) - 1.0) < 0.2


@pytest.mark.parametrize("conv", ["gat", "transformer"])
def test_attention_convs_raise(conv):
    edges, x, labels, masks = _toy()
    with pytest.raises(ValueError, match="gcn|graphsage"):
        sfb.ShardedFullBatchTrainer(
            edges, x, labels, *masks, Mesh(4, "cpu"),
            sfb.ShardedFullBatchConfig(conv=conv))


def test_make_mesh_entry_point_needs_cuda(monkeypatch):
    """Through make_mesh(P) the trainer runs on CUDA: without a card it
    raises unless given device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(4)
    edges, x, labels, masks = _toy()
    pt = sfb.ShardedFullBatchTrainer(edges, x, labels, *masks,
                                     make_mesh(4, device="cpu"))
    assert pt.x.device.type == "cpu"
