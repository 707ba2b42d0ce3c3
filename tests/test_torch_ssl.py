"""The port's self-supervised family against the JAX reference: every SSL
and ranking loss (values and gradients), every head (converted by
params_from_flax), the augmentations (the apply halves against the
reference's formulas with the same masks; the draws at rates 0 and 1,
where both are deterministic, against augment_view), each of the seven
tasks' step against the reference's step composed from encoder.apply,
head.apply and jax.value_and_grad, fed the masks and permutation the port
drew, ema_update bit-equal, a 5-step BGRL trajectory with its EMA target
and fit at rates 0 (no draw: both deterministic). Small sizes (N 120,
fanouts (3, 2), batch 16, hidden 8) on the CPU, where the kernels run
their plain twins.

Tolerances: fp32 losses within 1e-5 relative and gradients within 1e-4
of each gradient's scale (the same math summed in another order; measured
~1e-6), held to 1e-4 of the largest gradient where a gradient is nearly
zero; ema_update bit-equal; 5-step losses and the target within 1e-4
relative (Adam's drift over steps); fit's last loss within 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigl_tpu.graph.csr import HeteroGraph as JaxHeteroGraph
from gigl_tpu.losses import losses as ref_losses
from gigl_tpu.models import augmentations as ref_aug
from gigl_tpu.models import ssl_tasks as ref_tasks
from gigl_tpu.models.encoders import GNNEncoder as JaxGNNEncoder
from gigl_tpu.training.dataset import DeviceGraph as JaxDeviceGraph
from gigl_tpu.training.ssl_trainer import (
    SSLTrainer as JaxSSLTrainer,
    SSLTrainerConfig as JaxSSLTrainerConfig,
)
from gigl_tpu_torch.convert import params_from_flax
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.losses import losses
from gigl_tpu_torch.models import augmentations as aug
from gigl_tpu_torch.models import ssl_tasks as tasks
from gigl_tpu_torch.models.encoders import GNNEncoder
from gigl_tpu_torch.training.dataset import DeviceGraph
from gigl_tpu_torch.training.ssl_trainer import (
    SSL_TASKS,
    SSLTrainer,
    SSLTrainerConfig,
)

torch.set_num_threads(1)

N, E, D, HID, OUT, B = 120, 900, 8, 8, 6, 16
FANOUTS = (3, 2)
OPT = {"learning_rate": "0.01"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_grads(got, want, rel=1e-4):
    """Each gradient within ``rel`` of its scale, or of the largest
    gradient's where its own is nearly zero."""
    largest = max(float(np.abs(w).max()) for w in want.values())
    for n, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(got[n]), w, rtol=0, atol=rel * max(
            float(np.abs(w).max()), 1e-2 * largest), err_msg=n)


# -- losses -------------------------------------------------------------------

def _views(seed=0, n=12, d=5):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, d)).astype(np.float32)
    b = (a + 0.5 * rng.normal(size=(n, d))).astype(np.float32)
    c = rng.normal(size=(n, d)).astype(np.float32)
    a[3] = 0.0        # a zero row: the norms' epsilons
    return a, b, c


LOSSES = {
    "grace": (lambda m, a, b, c: m.grace_loss(a, b, temperature=0.3), 2),
    "bgrl": (lambda m, a, b, c: m.bgrl_loss(a, b), 2),
    "tbgrl": (lambda m, a, b, c: m.tbgrl_loss(a, b, c), 3),
    "gbt": (lambda m, a, b, c: m.gbt_loss(a, b), 2),
    "whitening": (lambda m, a, b, c: m.whitening_decorrelation_loss(a, b),
                  2),
    "feature_recon": (lambda m, a, b, c: m.feature_reconstruction_loss(
        a, b, gamma=2.0), 2),
    "alignment": (lambda m, a, b, c: m.alignment_loss(a, b), 2),
    "uniformity": (lambda m, a, b, c: m.uniformity_loss(a, t=2.0), 1),
    "kl": (lambda m, a, b, c: m.kl_loss(a, b, temperature=0.5), 2),
    "llp_ranking": (lambda m, a, b, c: m.llp_ranking_loss(
        a[:, 0], b, temperature=0.7), 2),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_gradients_match_jax(name):
    fn, n_args = LOSSES[name]
    arrays = _views()
    want, jg = jax.value_and_grad(
        lambda *xs: fn(ref_losses, *xs, *arrays[len(xs):]),
        argnums=tuple(range(n_args)))(*map(jnp.asarray, arrays[:n_args]))
    ts = [torch.from_numpy(a).requires_grad_(i < n_args)
          for i, a in enumerate(arrays)]
    got = fn(losses, *ts)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    # a stop-gradient input: no gradient in the port, zeros in JAX
    _close_grads({i: np.zeros(arrays[i].shape, np.float32)
                  if ts[i].grad is None else ts[i].grad.numpy()
                  for i in range(n_args)},
                 {i: g for i, g in enumerate(jg)})


# -- heads --------------------------------------------------------------------

def _head_pair(name):
    """(reference head, its inputs, the port head loaded from it)."""
    z1, z2, z3 = _views(seed=1, n=10, d=OUT)
    x = np.random.default_rng(2).normal(size=(10, D)).astype(np.float32)
    made = {
        "grace": (ref_tasks.GraceTask(hidden_dim=16, out_dim=4),
                  tasks.GraceTask(OUT, hidden_dim=16, out_dim=4), (z1, z2)),
        "whitening": (ref_tasks.WhiteningDecorrelationTask(hidden_dim=16,
                                                           out_dim=4),
                      tasks.WhiteningDecorrelationTask(OUT, 16, 4), (z1, z2)),
        "gbt": (ref_tasks.GBTTask(), tasks.GBTTask(), (z1, z2)),
        "feature_recon": (ref_tasks.FeatureReconstructionTask(hidden_dim=16),
                          tasks.FeatureReconstructionTask(OUT, D, 16),
                          (z1, x)),
        "bgrl": (ref_tasks.BGRLTask(hidden_dim=16),
                 tasks.BGRLTask(OUT, 16), (z1, z2, z2, z1)),
        "tbgrl": (ref_tasks.TBGRLTask(hidden_dim=16),
                  tasks.TBGRLTask(OUT, 16), (z1, z2, z2, z1, z3)),
        "directau": (ref_tasks.DirectAUTask(gamma=0.5),
                     tasks.DirectAUTask(gamma=0.5), (z1, z2)),
    }
    ref, port, inputs = made[name]
    v = _np(ref.init(jax.random.PRNGKey(3), *map(jnp.asarray, inputs)))
    if v:
        port.load_state_dict(params_from_flax(v))
    return ref, v, port, inputs


@pytest.mark.parametrize("name", ["grace", "whitening", "gbt",
                                  "feature_recon", "bgrl", "tbgrl",
                                  "directau"])
def test_head_matches_jax(name):
    """Each head's loss and its gradients into its parameters and its first
    input (the online view's embedding)."""
    ref, v, port, inputs = _head_pair(name)
    jin = list(map(jnp.asarray, inputs))

    def jloss(p, z):
        return ref.apply(p, z, *jin[1:]) if p else ref.apply({}, z, *jin[1:])

    want, (jgp, jgz) = jax.value_and_grad(jloss, argnums=(0, 1))(v, jin[0])
    tin = [torch.from_numpy(a) for a in inputs]
    tin[0].requires_grad_(True)
    got = port(*tin)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_g = dict(params_from_flax(_np(jgp))) if v else {}
    want_g["z"] = jgz
    _close_grads({**{n: p.grad.numpy() for n, p in port.named_parameters()},
                  "z": tin[0].grad.numpy()}, want_g)


def test_multitask_container_and_ema_update_bit_equal():
    z1, z2, _ = _views(seed=4, n=10, d=OUT)
    ref = ref_tasks.MultiTaskSSL([
        ref_tasks.WeightedTask("gbt", ref_tasks.GBTTask(), 0.5),
        ref_tasks.WeightedTask("au", ref_tasks.DirectAUTask(), 2.0)])
    port = tasks.MultiTaskSSL([
        tasks.WeightedTask("gbt", tasks.GBTTask(), 0.5),
        tasks.WeightedTask("au", tasks.DirectAUTask(), 2.0)])
    params = ref.init(jax.random.PRNGKey(0), z1=jnp.asarray(z1),
                      z2=jnp.asarray(z2))
    want, want_per = ref.loss(params, z1=jnp.asarray(z1), z2=jnp.asarray(z2))
    got, got_per = port.loss(z1=torch.from_numpy(z1), z2=torch.from_numpy(z2))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert set(got_per) == set(want_per)
    with pytest.raises(ValueError, match="duplicate"):
        tasks.MultiTaskSSL([tasks.WeightedTask("a", tasks.GBTTask()),
                            tasks.WeightedTask("a", tasks.GBTTask())])
    # ema_update: the reference's formula, bit-equal
    rng = np.random.default_rng(5)
    t_np = {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32)}
    o_np = {k: rng.normal(size=a.shape).astype(np.float32)
            for k, a in t_np.items()}
    want = ref_tasks.ema_update(t_np, o_np, 0.99)

    class P(torch.nn.Module):
        def __init__(self, tree):
            super().__init__()
            for k, a in tree.items():
                self.register_parameter(k, torch.nn.Parameter(
                    torch.from_numpy(a.copy())))

    target = P(t_np)
    tasks.ema_update(target, P(o_np), 0.99)
    for k in t_np:
        np.testing.assert_array_equal(getattr(target, k).detach().numpy(),
                                      np.asarray(want[k]))


# -- augmentations -------------------------------------------------------------

def _hops(seed=6):
    rng = np.random.default_rng(seed)
    shapes = [(B,), (B, 3), (B, 3, 2)]
    feats = [rng.normal(size=s + (D,)).astype(np.float32) for s in shapes]
    masks = [np.ones((B,), bool)] + [rng.random(s) < 0.8 for s in shapes[1:]]
    return feats, masks


def test_augmentation_apply_halves_match_the_reference_formulas():
    feats, masks = _hops()
    gen = torch.Generator().manual_seed(0)
    tf = [torch.from_numpy(f) for f in feats]
    tm = [torch.from_numpy(m) for m in masks]
    draw = aug.draw_view(gen, tf, tm, feature_drop_rate=0.4,
                         edge_drop_rate=0.3, corrupt=True)
    got_f, got_m = aug.apply_view(tf, tm, draw)
    # the reference's feature_dropout / edge_dropout_masks / corruption
    # with the same keeps
    for i, f in enumerate(feats):
        want = jnp.asarray(f) * jnp.asarray(
            draw.feature_keeps[i].numpy()).astype(jnp.float32)
        if i == 0:
            want = want[jnp.asarray(draw.perm.numpy())]
        np.testing.assert_array_equal(got_f[i].numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_m[0].numpy(), masks[0])
    for i in (1, 2):
        want = jnp.asarray(masks[i]) & jnp.asarray(
            draw.edge_keeps[i - 1].numpy())
        np.testing.assert_array_equal(got_m[i].numpy(), np.asarray(want))
    assert sorted(draw.perm.tolist()) == list(range(B))
    kept = np.concatenate([k.numpy() for k in draw.feature_keeps])
    assert 0 < kept.mean() < 1


@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_augment_view_draws_at_rates_zero_and_one(rate):
    """Both packages are deterministic at these rates: nothing dropped, or
    everything but the roots' mask."""
    feats, masks = _hops(seed=7)
    want_f, want_m = ref_aug.augment_view(
        jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats],
        [jnp.asarray(m) for m in masks], feature_drop_rate=rate,
        edge_drop_rate=rate)
    got_f, got_m = aug.augment_view(
        torch.Generator().manual_seed(0), [torch.from_numpy(f)
                                           for f in feats],
        [torch.from_numpy(m) for m in masks], feature_drop_rate=rate,
        edge_drop_rate=rate)
    for g, w in zip(got_f + got_m, want_f + want_m):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert aug.draw_view(torch.Generator(), feats and [torch.from_numpy(
        f) for f in feats], [torch.from_numpy(m) for m in masks],
        feature_drop_rate=0.0, edge_drop_rate=0.0).edge_keeps is None


# -- the trainer ---------------------------------------------------------------

def _graphs(seed=8):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    x = rng.normal(size=(N, D)).astype(np.float32)
    sup = np.stack([src[:400], dst[:400]])
    jg = JaxDeviceGraph.from_hetero(JaxHeteroGraph.homogeneous(
        src=src, dst=dst, num_nodes=N, node_features=x),
        supervision_edges=sup)
    pg = DeviceGraph.from_hetero(HeteroGraph.homogeneous(
        src=src, dst=dst, num_nodes=N, node_features=x),
        supervision_edges=sup, device="cpu")
    return jg, pg


def _pair(task, rates=(0.3, 0.25), seed=2):
    jg, pg = _graphs()
    cfg = dict(task=task, fanouts=FANOUTS, feature_drop_rate=rates[0],
               edge_drop_rate=rates[1], ema_decay=0.9, seed=seed)
    jt = JaxSSLTrainer(JaxGNNEncoder(hid_dim=HID, out_dim=OUT), jg,
                       JaxSSLTrainerConfig(**cfg), optimizer_args=OPT)
    js = jt.init_state(jax.random.PRNGKey(0), batch_size=B)
    pt = SSLTrainer(GNNEncoder(D, HID, OUT), pg, SSLTrainerConfig(**cfg),
                    optimizer_args=OPT, device="cpu")
    ps = pt.init_state(params=params_from_flax(_np(js.params)))
    return jt, js, pt, ps


def _ref_view(jt, enc_params, feats, masks, degs, draw):
    """The reference's _encode_view with the port's draws in place of
    augment_view's."""
    f = [fi if k is None else fi * jnp.asarray(k.numpy()).astype(fi.dtype)
         for fi, k in zip(feats, draw.feature_keeps)]
    if draw.perm is not None:
        f[0] = f[0][jnp.asarray(draw.perm.numpy())]
    m = list(masks) if draw.edge_keeps is None else [masks[0]] + [
        mi & jnp.asarray(k.numpy()) for mi, k in zip(masks[1:],
                                                      draw.edge_keeps)]
    return jt.encoder.apply(enc_params, f, m, None, hop_degrees=degs)


def _ref_loss(jt, params, target, nodes, views, step):
    """The reference's SSLTrainer._loss, composed, with the port's draws."""
    g, task = jt.graph, jt.cfg.task
    blocks = g.sample_hop_blocks(nodes, jt.cfg.fanouts, seed=jt.cfg.seed)
    feats, masks, degs = g.hydrate(blocks)
    z1 = _ref_view(jt, params["encoder"], feats, masks, degs, views["v1"])
    if task == "feature_recon":
        return jt.head.apply(params["head"], z1, g.node_features[nodes])
    if task == "directau":
        batch = g.sample_nalp_batch(nodes, num_positives=1,
                                    num_random_negs=1, seed=jt.cfg.seed,
                                    step=step)
        zp = jt._encode_impl(g, params["encoder"], batch.pos[:, 0])
        return jt.head.apply(params["head"], z1, zp)
    z2 = _ref_view(jt, params["encoder"], feats, masks, degs, views["v2"])
    if task in ("grace", "gbt", "whitening"):
        return jt.head.apply(params["head"], z1, z2)
    t1 = _ref_view(jt, target, feats, masks, degs, views["v1"])
    t2 = _ref_view(jt, target, feats, masks, degs, views["v2"])
    if task == "bgrl":
        return jt.head.apply(params["head"], z1, z2, t1, t2)
    neg = _ref_view(jt, target, feats, masks, degs, views["neg"])
    return jt.head.apply(params["head"], z1, z2, t1, t2, neg)


@pytest.mark.parametrize("task", SSL_TASKS)
def test_task_step_matches_the_reference_composition(task):
    """Step 3's loss and gradients (DirectAU's batch keyed by the step)
    against the reference's _loss composed with value_and_grad, fed the
    views the port drew; the tree bit-equal to the reference's."""
    jt, js, pt, ps = _pair(task)
    nodes = np.random.default_rng(9).integers(0, N, B)
    views = pt.draw_views(B, torch.Generator().manual_seed(1))
    jn = jnp.asarray(nodes, jnp.int32)
    jf = jt.graph.hydrate(jt.graph.sample_hop_blocks(jn, FANOUTS,
                                                     seed=jt.cfg.seed))[0]
    pf = pt._tree(pt._ids(nodes))[0]
    for a, b in zip(pf, jf):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # jit: one compile instead of an eager one per op
    want, jg = jax.jit(jax.value_and_grad(
        lambda p: _ref_loss(jt, p, js.target_params, jn, views, 3)))(
            js.params)
    loss = pt.loss(nodes, views, 3, ps.target)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    want_g = params_from_flax(_np(jg))
    got_g = {n: p.grad.numpy() for n, p in pt.model.named_parameters()
             if p.grad is not None}
    assert set(got_g) == set(want_g)
    _close_grads(got_g, want_g)
    if task in ("bgrl", "tbgrl"):
        assert all(p.grad is None for p in ps.target.parameters())


def test_bgrl_trajectory_and_target_at_rate_zero():
    """At rates 0 nothing is drawn, so the reference's jitted train_step
    and the port's take the same 5 steps: the losses and the EMA target
    agree."""
    jt, js, pt, ps = _pair("bgrl", rates=(0.0, 0.0))
    rng = np.random.default_rng(10)
    want, got = [], []
    for k in range(5):
        nodes = rng.integers(0, N, B)
        js, loss = jt.train_step(js, nodes, jax.random.PRNGKey(k))
        want.append(float(loss))
        ps, loss = pt.train_step(ps, nodes, torch.Generator())
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    target = params_from_flax(_np(js.target_params))
    for n, t in ps.target.state_dict().items():
        np.testing.assert_allclose(t.numpy(), target[n].numpy(), rtol=0,
                                   atol=1e-4 * float(target[n].abs().max()))
    assert ps.step == 5


def test_fit_matches_jax_at_rate_zero():
    jt, js, pt, ps = _pair("grace", rates=(0.0, 0.0))
    nodes = np.arange(N)
    _, want = jt.fit(js, nodes, batch_size=B, num_epochs=2, log_every=100)
    ps, got = pt.fit(ps, nodes, batch_size=B, num_epochs=2, log_every=100)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert ps.step == 2 * (N // B)


def test_device_rules_and_unknown_task():
    _, pg = _graphs()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SSLTrainer(GNNEncoder(D, HID, OUT), pg, SSLTrainerConfig())
    with pytest.raises(ValueError, match="Unknown SSL task"):
        SSLTrainer(GNNEncoder(D, HID, OUT), pg, SSLTrainerConfig(task="x"),
                   device="cpu")
    t = SSLTrainer(GNNEncoder(D, HID, OUT, batchnorm=True), pg,
                   SSLTrainerConfig(fanouts=FANOUTS), device="cpu")
    state = t.init_state(0)
    # the reference applies its encoder in eval mode: batch norm trains
    # from its running statistics, which stay put
    state, loss = t.train_step(state, np.arange(B), torch.Generator())
    assert np.isfinite(float(loss))
    assert float(t.encoder.bns[0].var.min()) == 1.0
    assert t.encode_batch(np.arange(5)).shape == (5, OUT)
